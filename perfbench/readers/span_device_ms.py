"""Device ms a unit of work (``per``) of the operations launched inside the
program's spans ``spans`` (a span and the spans nested in it), from the
trace of host and device."""


def read(spec, run):
    device = run.get("spans", {}).get("device_ns", {})
    ns = [device[s] for s in spec["spans"] if s in device]
    units = run.get("labelled", {}).get("units", {}).get(spec["per"])
    if not ns or not units:
        return None
    return 1e-6 * sum(ns) / units
