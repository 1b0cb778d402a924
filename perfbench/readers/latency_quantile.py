"""A quantile ``q`` of the requests' latencies over the untraced part of
the window, in ms."""

import numpy as np


def read(spec, run):
    lat = run["host"].get("latency_s")
    if not lat:
        return None
    return 1e3 * float(np.quantile(lat, spec["q"]))
