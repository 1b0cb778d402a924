"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m perfbench.run --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The run makes the cell's weights and traffic from ``--seed`` on
the card, builds the port's trainer or predictor, warms up the cell's
shapes (all of that is ``setup_s``, timed from the process's start), then
measures for ``--seconds``. With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics. With ``--trace 1`` the first half of the
window is measured as usual, the next 40% under a torch.profiler trace of
the device alone and the last 10% under one of host and device; the
metrics are the cell's per-layer metrics, read by ``readers/<reader>.py``
as ``metrics/<name>.json`` says. After the window, with the peak memory
read and the program freed, ``loops/<loop>.py`` compares what the timed
path produced with the plain reference; each number that
``limits/<cell>.json`` names is held to its limit there.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit,
which the last lines of standard error repeat. Exit 2, with no result, on
a machine without CUDA or with fewer cards than the cell asks for; exit 3
if ``jax``, ``jaxlib``, ``flax`` or ``recman_tpu`` was imported.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "recman_tpu")
# a traced run's window: the first half as a plain run's, this share under
# a trace of the device alone, the rest under a trace of host and device
DEVICE_TRACED = 0.4


class ForbiddenImport(RuntimeError):
    """The run loaded a module of ``FORBIDDEN``."""


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (10 ms
    resolution), or now where /proc cannot say."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - started, 0.0)
    except (OSError, ValueError, IndexError):
        return now


def cache_dirs(root: Path = ROOT):
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def quantity(name: str) -> str:
    """The quantity an end-to-end metric reports: its name up to the first
    dot (``train_examples_per_s.device_bound`` is ``train_examples_per_s``
    held to a bound of its own in the cells it lists)."""
    return name.split(".", 1)[0]


def imported_forbidden() -> list:
    """Top-level names of loaded modules that the run may not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name, seed, seconds, trace, device="cuda", started=None, make_program=None,
             bench=None):
    """One run of cell ``name``: the result dict. ``make_program`` replaces
    the port (the control and the fault tests)."""
    import torch

    from . import spec
    from . import trace as tracing
    from .program import set_precision

    started = time.perf_counter() if started is None else started
    cell = spec.cell(name, bench)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    loop = spec.module("loops", traffic["loop"])
    set_precision(cfg)
    cuda = torch.device(device).type == "cuda"
    state = loop.setup(cfg, traffic, seed, device, make_program)
    setup_s = time.perf_counter() - started
    host = loop.window(state, seconds / 2 if trace else seconds)
    records = [host]
    if trace:
        with tracing.traced(device, host_ops=False) as reduced:
            traced_rec = loop.window(state, seconds * DEVICE_TRACED)
        with tracing.traced(device, host_ops=True) as labelled:
            records += [traced_rec, loop.window(state, seconds * (0.5 - DEVICE_TRACED))]
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = imported_forbidden()
    if bad:
        raise ForbiddenImport(f"the run imported {bad}")
    attempted, failed = loop.finish(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = loop.check(state)
    limits = spec.limits(name)
    check = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None,
                 "limit": limit} for k, limit in limits.items()}
    correct = bool(failed == 0 and all(
        None not in (c["value"], c["limit"]) and c["value"] <= c["limit"]
        for c in check.values()))

    device_out = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell["chips"],
                  "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        run = {"cfg": cfg, "traffic": traffic, "host": host, "traced": traced_rec,
               "trace": reduced, "peaks": spec.peaks(kind) if cuda else None,
               "costs": spec.module("costs", cfg["costs"])}
        metrics = {}
        for m in cell["per_layer"]:
            mspec = spec.metric(m["name"])
            value = spec.module("readers", mspec["reader"]).read(mspec, run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_out.update(busy_s=reduced["busy_s"], window_s=traced_rec["seconds"])
        result.update(metrics=metrics, device=device_out, breakdown={
            "device_ops": tracing.top(reduced["device_ns"], 1e-9),
            "idle_gaps": tracing.top(labelled["idle_gaps"])})
    else:
        values = dict(loop.end_to_end(records), setup_s=setup_s)
        result.update(metrics={m["name"]: {"value": values[quantity(m["name"])],
                                           "unit": m["unit"]} for m in cell["end_to_end"]},
                      device=device_out)
    result["check"] = check
    return result


def cli(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    from . import spec

    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          started=started)
    except ForbiddenImport as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    bad = imported_forbidden()
    if bad:
        print(f"perfbench: the run imported {bad}", file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
