"""A torch.profiler trace of part of a window, reduced to what the readers
take: the device's busy seconds, device time by operation name, and the
idle gaps between device operations by what the host was doing.

Recording the host's operations costs microseconds each, which slows a
step of thousands of them and leaves the card idle meanwhile; so the
device's numbers come from a trace of device activity alone
(``host_ops=False``), and only the labels of the idle gaps from a short
trace of both.
"""

from __future__ import annotations

import bisect
import contextlib

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOP = 10
NAME_CHARS = 160
GAP_MIN_NS = 5_000      # shorter gaps are launch spacing, not waiting
GAPS_LABELLED = 4_000   # the longest gaps that get a label


@contextlib.contextmanager
def traced(device, host_ops):
    """Profile the body; yields a dict that holds the reduction after it."""
    cuda = torch.device(device).type == "cuda"
    activities = ([ProfilerActivity.CPU] if host_ops or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    out = {}
    with profile(activities=activities) as prof:
        yield out
    out.update(reduce(prof.profiler.kineto_results.events()))


def reduce(events) -> dict:
    dev, host = [], []
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((start, end, e.name()))
        elif e.duration_ns() > 0:
            host.append((start, end, e.name()))
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    dev.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                if s - cur_e >= GAP_MIN_NS:
                    gaps.append((s - cur_e, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return {"busy_s": busy * 1e-9, "device_ns": by_name,
            "idle_gaps": _label(sorted(gaps, reverse=True)[:GAPS_LABELLED], host)}


def _label(gaps, host):
    """Idle seconds summed by the innermost host operation running when
    each gap began (the longest ``GAPS_LABELLED`` gaps)."""
    host.sort()
    starts = [h[0] for h in host]
    out = {}
    for length, at in gaps:
        i = bisect.bisect_right(starts, at)
        name, best = "no host operation", None
        for s, e, n in reversed(host[max(0, i - 400):i]):
            if e >= at and (best is None or s > best):
                name, best = n, s
                break
        out[name] = out.get(name, 0.0) + length * 1e-9
    return out


def top(d: dict, scale: float = 1.0) -> list:
    """The ``TOP`` largest entries as [[name, value * scale], ...]."""
    items = sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:NAME_CHARS], value * scale] for name, value in items]
