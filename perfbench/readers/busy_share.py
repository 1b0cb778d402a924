"""The device's busy share of the traced window, in %: the seconds in which
an operation ran on the card, from the trace of the device alone, over
that window's own wall seconds (``device.busy_s`` over
``device.window_s``). The trace's per-launch cost slows the host, so a
host-paced cell reads idler here than untraced."""


def read(spec, run):
    trace, traced = run["trace"], run["traced"]
    if not trace.get("device_ns") or traced["seconds"] <= 0:
        return None
    return 100.0 * trace["busy_s"] / traced["seconds"]
