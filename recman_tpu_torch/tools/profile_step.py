"""Profile the bench train step with torch.profiler and print where its
time goes.

Counterpart of the JAX package's ``tools/profile_step.py``. Runs
``--steps`` steps of ``tools.bench``'s step (``--path std``: the stacked
storage the bench ships; ``per-table``: per-table leaves) under
torch.profiler, sums each CUDA kernel's device time by name, and sums
those by ``categorize`` into the reference's categories, read for CUDA:
``index_add`` and scatter kernels under scatter, cuBLAS and CUTLASS GEMMs
under conv/dot, the port's own kernels (the ``__global__`` functions of
``csrc/``: K1-K7) under hand-written where the reference had "pallas",
NCCL and Gloo under allreduce. Memory copies and sets fall under
copy/transpose. It prints the top ``--top`` names and one JSON line: ms
per step by category, the profiled total, the step's device time (CUDA
events between unprofiled steps) and the card's name and power limit.

On the CPU (``--device cpu``) it profiles the operators' self CPU time
instead, under the same categories.

Run from the repository root on a machine with a CUDA GPU:

    python -m recman_tpu_torch.tools.profile_step [--steps 5] [--top 40]
        [--path std|per-table] [--batch 8192]
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys

from . import bench

# each kernel's __global__ functions in csrc/ (K3 and K7 share theirs; K1 and K2
# write their layer tables with write_table)
KERNEL_SYMBOLS = {
    "K1": ("cin_chain_fwd_kernel", "write_table"),
    "K2": ("cin_chain_bwd_cols", "cin_bwd_dw", "cin_chain_bwd_reduce", "write_table"),
    "K3": ("map_clear_kernel", "segment_sums_kernel", "segment_fixup_kernel",
           "segment_write_kernel"),
    "K4": ("cin_interact_fwd_kernel",),
    "K5": ("cin_interact_bwd_cols", "cin_bwd_dw", "cin_interact_bwd_reduce"),
    "K6": ("one_table_kernel",),
    "K7": ("map_clear_kernel", "segment_sums_kernel", "segment_fixup_kernel",
           "segment_write_kernel"),
}
_SYMBOLS = sorted({s for names in KERNEL_SYMBOLS.values() for s in names})

CATEGORIES = (
    ("hand-written", re.compile(r"\b(" + "|".join(_SYMBOLS) + r")\b")),
    ("allreduce", re.compile(r"nccl|gloo|all_?reduce|all_?gather|reduce_?scatter|all_to_all",
                             re.I)),
    ("sort", re.compile(r"sort", re.I)),
    ("scatter", re.compile(r"scatter|index_?add|indexFunc", re.I)),
    ("gather/take", re.compile(r"gather|index_?select|indexSelect|embedding|take", re.I)),
    ("conv/dot", re.compile(r"gemm|gemv|cutlass|cublas|nvjet|xmma|splitK|\bmm\b|addmm|bmm|"
                            r"matmul|linear|dot|conv", re.I)),
    ("copy/transpose", re.compile(r"copy|memcpy|memset|transpose|contiguous|\bcat\b|clone",
                                  re.I)),
)


def categorize(name: str) -> str:
    """The category of a kernel's or an operator's name."""
    for cat, rx in CATEGORIES:
        if rx.search(name):
            return cat
    return "other"


def by_category(times: dict) -> dict:
    """{category: ms} summed over ``times`` ({name: ms})."""
    out = {}
    for name, ms in times.items():
        cat = categorize(name)
        out[cat] = out.get(cat, 0.0) + ms
    return out


def run(steps=5, path="std", batch=None, top=40, device=None, num_buckets=bench.NUM_BUCKETS,
        n_rows=bench.N_ROWS, hparams=None):
    """Profile ``steps`` bench steps; prints the table and the JSON line,
    returns the line's dict (``kernels``: ms per step by name)."""
    model, data, layout, optimizer = bench.build_bench_setup(device, num_buckets, n_rows, hparams)
    device = next(iter(data.values())).device
    step, state = bench.bench_state(model, optimizer, device, per_table=path == "per-table")
    idx = bench.bench_batches(n_rows, batch or bench.BATCH_SIZE, device)
    box = {"state": state, "i": 0}

    def one():
        i = box["i"] = box["i"] + 1
        box["state"], _ = step(box["state"], data, idx[i % len(idx)], layout)

    for _ in range(3):  # warm-up
        one()
    bench.sync(device)
    timer = bench.StepTimer(device)
    timer.mark()
    for _ in range(steps):
        one()
        timer.mark()
    bench.sync(device)
    step_ms = statistics.median(timer.step_ms())
    kernels = bench.kernel_times(one, steps, device)
    total = sum(kernels.values())
    cats = by_category(kernels)
    unit = "device" if device.type == "cuda" else "cpu self"
    print(f"{steps} steps, {unit} time {total:.4f} ms/step, step {step_ms:.4f} ms")
    print("\n-- by category (ms/step) --")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"{ms:10.4f}  {cat}")
    print(f"\n-- top {top} ({unit} ms/step) --")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{ms:10.4f}  {categorize(name):14s}  {name[:100]}")
    line = {
        "metric": "bench_step_profile",
        "path": path,
        "batch": batch or bench.BATCH_SIZE,
        "steps": steps,
        "time": unit,
        "ms_per_step_by_category": cats,
        "profiled_ms_per_step": total,
        "step_ms": step_ms,
        "hand_written": sorted(n for n in kernels if categorize(n) == "hand-written"),
        "device": device.type,
        "card": bench.card_of(device),
    }
    print(json.dumps(line), flush=True)
    line["kernels"] = kernels
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--path", choices=("std", "per-table"), default="std",
                    help="std: the stacked storage the bench ships")
    ap.add_argument("--batch", type=int, default=None, help="default: the bench's 8192")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    run(args.steps, args.path, args.batch, args.top, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
