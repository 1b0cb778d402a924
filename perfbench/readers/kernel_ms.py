"""Device milliseconds a unit of work (``per``: step, request, batch) in
the operations whose names match ``kernels``, from the trace."""

import re


def device_seconds(trace, pattern):
    rx = re.compile(pattern)
    hits = [ns for name, ns in trace.get("device_ns", {}).items() if rx.search(name)]
    return sum(hits) * 1e-9 if hits else None


def read(spec, run):
    s = device_seconds(run["trace"], spec["kernels"])
    units = run["traced"]["units"].get(spec["per"])
    if s is None or not units:
        return None
    return 1e3 * s / units
