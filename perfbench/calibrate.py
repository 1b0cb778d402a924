"""The readings that a cell's limits are set from, in one process.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,... \
        [--as program|control|<fault>] [--seconds 2]

For each seed, on the card: the cell's set-up with the port (or, with
``--as``, the control or a fault of ``faults.PROGRAMS`` in its place), a
scoring cell's window of ``--seconds``, then the numbers that ``run``
compares, against the reference at the configuration's precision. One
JSON line a seed, then the largest and the smallest reading of each
number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import spec
from .faults import PROGRAMS
from .program import set_precision
from .run import cache_dirs


def leaves(prog, ref):
    """Every leaf of the first gradient, worst first: (leaf, the gap as
    ``loops.train.compare`` takes it, the reference gradient's norm over
    the norm of its terms' magnitudes summed); and the change's ``n``
    worst leaves with their gaps."""
    out = {}
    for side in ("grad", "change"):
        med = sorted(ref[side].values())[len(ref[side]) // 2]
        gap = {k: abs(prog[side][k] - ref[side][k]) / max(ref[side][k], med) for k in ref[side]}
        out[side] = [(k, gap[k], ref["grad"][k] / ref["terms"][k] if ref["terms"][k] else None)
                     for k in sorted(gap, key=lambda k: -gap[k])]
    out["change"] = out["change"][:5]
    out["loss"] = list(zip(prog["loss"], ref["loss"]))
    return out


def readings(name, seeds, kind="program", seconds=2.0):
    cell = spec.cell(name)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    loop = spec.module("loops", traffic["loop"])
    make = None if kind == "program" else PROGRAMS[kind][traffic["loop"]]
    set_precision(cfg)
    out = []
    for seed in seeds:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        state = loop.setup(cfg, traffic, seed, "cuda", make)
        if traffic["loop"] != "train":
            loop.window(state, seconds)
        loop.finish(state)
        gc.collect()
        torch.cuda.empty_cache()
        line = {"cell": name, "as": kind, "seed": seed}
        if traffic["loop"] == "train":
            ref = loop.reference_readings(state, cfg["precision"])
            numbers = loop.compare(state["readings"], ref)
            line["leaves"] = leaves(state["readings"], ref)
        else:
            numbers = loop.check(state)
        del state
        gc.collect()
        line.update(numbers=numbers, seconds=time.perf_counter() - t,
                    memory_peak_bytes=torch.cuda.max_memory_allocated())
        print(json.dumps(line), flush=True)
        out.append(numbers)
    summary = {k: {"max": max(n[k] for n in out), "min": min(n[k] for n in out)}
               for k in out[0]}
    print(json.dumps({"cell": name, "as": kind, "seeds": len(out), "summary": summary}),
          flush=True)
    return out


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--as", dest="kind", default="program",
                    choices=["program", *PROGRAMS])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cache_dirs()
    readings(args.workload, [int(s) for s in args.seeds.split(",")], args.kind, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
