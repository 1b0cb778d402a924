"""The program's counters ``part`` over ``whole`` (each summed), in %: their
change over the untraced window (``run["host"]``)."""


def read(spec, run):
    c = run.get("counters", {})
    if not all(k in c for k in spec["part"] + spec["whole"]):
        return None
    whole = sum(c[k] for k in spec["whole"])
    return 100.0 * sum(c[k] for k in spec["part"]) / whole if whole else None
