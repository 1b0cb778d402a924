"""Named spans at the port's layer boundaries, on the profiler's clock.

``span(name)`` marks one layer's work: the training step and its loss,
backward and optimizer (``training/train_step.py``), and
``Predictor.predict`` with its copies, forwards and wait (``serving.py``).
Every span's name starts with ``PREFIX``, which tells it apart from
PyTorch's own operations in a trace.

- Off (no ``recording()`` and no torch.profiler session), ``span`` checks
  one flag and returns the shared ``NOOP``: it allocates nothing, records
  nothing and never synchronises.
- Under a torch.profiler session the span is a range of the profiler's
  trace, beside the kernels it launches. It is recorded as a plain host
  operation, not as ``record_function``'s user annotation: the profiler
  copies each annotation onto the device's timeline as an event that
  spans its kernels and the idle time between them, which a reader that
  sums device events would count as work.
- Under ``recording()`` each span is kept in memory as a ``SpanRecord``.
  A span opened with no span open on its thread is a root and takes a new
  ``id``; the spans inside it carry that ``id`` and their parent's name.
  Times are ``time.time_ns()``, the clock that the profiler's events are
  on, so a record can be matched to the kernels launched inside it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "recman."


class SpanRecord(NamedTuple):
    name: str
    parent: str | None
    id: int
    start_ns: int
    end_ns: int


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Recorder:
    def __init__(self):
        self.records: list = []
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_recorder: _Recorder | None = None


class _Span:
    __slots__ = ("name", "recorder", "range", "parent", "id", "start")

    def __init__(self, name, recorder):
        self.name, self.recorder, self.range = name, recorder, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        if self.recorder is not None:
            stack = self.recorder.stack()
            if stack:
                self.parent, self.id = stack[-1].name, stack[-1].id
            else:
                self.parent, self.id = None, next(self.recorder.ids)
            stack.append(self)
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self.recorder
        if rec is not None:
            end = time.time_ns()
            rec.stack().pop()
            rec.records.append(SpanRecord(self.name, self.parent, self.id, self.start, end))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's work, named ``PREFIX + name``."""
    if _recorder is None and not _profiler._is_profiler_enabled:
        return NOOP
    return _Span(PREFIX + name, _recorder)


@contextlib.contextmanager
def recording():
    """Keep every span that ends inside the body; yields the list of
    ``SpanRecord`` it fills, in the order the spans end."""
    global _recorder
    outer, _recorder = _recorder, _Recorder()
    try:
        yield _recorder.records
    finally:
        _recorder = outer
