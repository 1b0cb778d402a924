"""The mean of the benchmark's host span ``span`` over the untraced part
of the window, in ms."""


def read(spec, run):
    spans = run["host"].get("spans", {}).get(spec["span"])
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
