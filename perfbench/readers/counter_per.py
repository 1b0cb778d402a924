"""The program's counter ``counter`` a unit of work (``per``), times
``scale``: its change over the untraced window (``run["host"]``) over that
window's units."""


def read(spec, run):
    c = run.get("counters", {})
    units = run.get("host", {}).get("units", {}).get(spec["per"])
    if spec["counter"] not in c or not units:
        return None
    return spec["scale"] * c[spec["counter"]] / units
