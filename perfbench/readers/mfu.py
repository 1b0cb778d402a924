"""Model FLOP utilization, in %: the model's operations on the rows of
the untraced part of the window (the cost function ``cost`` times
``factor``: 3 for a training step, 1 for a forward) over its wall
seconds, against the card's bf16 peak."""


def read(spec, run):
    peaks = run["peaks"]
    cost = getattr(run["costs"], spec["cost"], None)
    host = run["host"]
    rows = host["units"].get(spec["per"])
    if peaks is None or cost is None or not rows:
        return None
    flops = spec["factor"] * cost(run["cfg"], rows)[0]
    return 100.0 * flops / host["seconds"] / peaks["bf16"]
