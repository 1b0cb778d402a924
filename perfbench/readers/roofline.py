"""A kernel's share of its roofline, in %: the least time the card could
take for the work (the larger of the operations at the ``peak`` rate and
the bytes at the memory's rate, from the configuration's shapes by the
cost function ``cost``, for each unit of work ``per`` of ``rows`` rows)
over the device time of the operations whose names match ``kernels``."""

from .kernel_ms import device_seconds


def read(spec, run):
    peaks = run["peaks"]
    cost = getattr(run["costs"], spec["cost"], None)
    s = device_seconds(run["trace"], spec["kernels"])
    units = run["traced"]["units"].get(spec["per"])
    if peaks is None or cost is None or s is None or not units:
        return None
    ops, nbytes = cost(run["cfg"], run["traffic"][spec["rows"]])
    least = max(ops / peaks[spec["peak"]], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * units * least / s
