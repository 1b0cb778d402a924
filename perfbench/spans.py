"""The program's spans and counters, reduced to what the span readers take
(``readers/span_*.py``, ``readers/counter_*.py``).

The readers take a run dict with ``spans`` and ``counters`` beside the
windows that ``perfbench.run`` already records:

- ``spans["host_ns"]``: host ns by span name (``host_ns``) of the
  program's span records over the untraced window (``run["host"]``),
  taken under ``recording()``. Host time is read there and not under a
  profiler, which stretches host spans (up to 1.7x on xDeepFM training)
  and changes the process's host costs after it.
- ``spans["device_ns"]``, ``spans["launches"]``, ``spans["idle_ns"]``: the
  trace of host and device (``run["labelled"]``) reduced by ``by_span``.
- ``counters``: the change of ``counters()`` over the untraced window.

``perfbench.run`` does not build them yet, so no per-layer metric of a
run reads them: a `benchmark` change wires them in (PERF.md §7). Until
``perfbench/program.py`` takes them over, ``recording`` and ``counters``
here are the one other place where the benchmark reaches into the port;
they read nothing, and raise nothing, where the port lacks them, and the
readers then give None.
"""

from __future__ import annotations

import bisect
import contextlib

from .trace import GAP_MIN_NS

PREFIX = "recman."  # the program's span names start so
OUTSIDE = "outside the program"
COUNTERS = ("ROWS", "PADDED_ROWS", "H2D_BYTES")


# -- the program's recording and counters ------------------------------------

def recording():
    """The program's span recording (yields its list of records), or a
    context that yields None."""
    try:
        from recman_tpu_torch.obs.trace import recording as program_recording
    except ImportError:
        return contextlib.nullcontext()
    return program_recording()


def counters() -> dict:
    """The serving front's counters now, those the program has."""
    try:
        from recman_tpu_torch import serving
    except ImportError:
        return {}
    return {k: getattr(serving, k) for k in COUNTERS if hasattr(serving, k)}


# -- the reduction -------------------------------------------------------------

def events(prof):
    """(program spans as (start, end, name), launch time by correlation id,
    device operations as (start, end, correlation id)) of a torch.profiler
    trace. The profiler's copies of user annotations on the device's
    timeline are not device work and are left out."""
    from torch.autograd import DeviceType

    spans, launches, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((s, s + d, e.correlation_id()))
        elif e.name().startswith(PREFIX):
            spans.append((s, s + d, e.name()))
        elif e.name().startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = s
    return spans, launches, ops


def timeline(spans):
    """(boundaries, names): from ``boundaries[i]`` to the next boundary the
    innermost of the nested ``spans`` is ``names[i]`` (None: no span)."""
    bounds, names, open_ = [], [], []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while open_ and open_[-1][0] <= s:
            bounds.append(open_.pop()[0])
            names.append(open_[-1][1] if open_ else None)
        open_.append((e, name))
        bounds.append(s)
        names.append(name)
    while open_:
        bounds.append(open_.pop()[0])
        names.append(open_[-1][1] if open_ else None)
    return bounds, names


def by_span(spans, launches, ops) -> dict:
    """Device ns, device operations launched and device idle ns by the
    innermost program span: of its launch for an operation, of its start
    for an idle gap of at least ``GAP_MIN_NS``."""
    bounds, names = timeline(spans)

    def label(t):
        i = bisect.bisect_right(bounds, t) - 1
        return (names[i] if i >= 0 else None) or OUTSIDE

    device, launched, idle = {}, {}, {}
    for s, e, corr in ops:
        at = launches.get(corr)
        name = OUTSIDE if at is None else label(at)
        device[name] = device.get(name, 0) + (e - s)
        launched[name] = launched.get(name, 0) + 1
    cur_e = None
    for s, e, _ in sorted(ops):
        if cur_e is not None and s - cur_e >= GAP_MIN_NS:
            name = label(cur_e)
            idle[name] = idle.get(name, 0) + (s - cur_e)
        cur_e = e if cur_e is None else max(cur_e, e)
    return {"device_ns": device, "launches": launched, "idle_ns": idle}


def host_ns(records) -> dict:
    """Host ns by span name of the program's span records (None: none)."""
    out = {}
    for r in records or ():
        out[r.name] = out.get(r.name, 0) + (r.end_ns - r.start_ns)
    return out
