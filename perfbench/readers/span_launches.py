"""Device operations launched a unit of work (``per``) inside the program's
spans ``spans``, from the trace of host and device."""


def read(spec, run):
    launched = run.get("spans", {}).get("launches", {})
    n = [launched[s] for s in spec["spans"] if s in launched]
    units = run.get("labelled", {}).get("units", {}).get(spec["per"])
    if not n or not units:
        return None
    return sum(n) / units
