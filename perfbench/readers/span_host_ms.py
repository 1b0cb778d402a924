"""Host ms a unit of work (``per``) inside the program's spans ``spans``,
from its span records over the untraced window (``run["host"]``): a
profiler stretches host spans and changes the process after it."""


def read(spec, run):
    host = run.get("spans", {}).get("host_ns", {})
    ns = [host[s] for s in spec["spans"] if s in host]
    units = run.get("host", {}).get("units", {}).get(spec["per"])
    if not ns or not units:
        return None
    return 1e-6 * sum(ns) / units
