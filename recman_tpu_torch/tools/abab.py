"""The ABAB measurement harness: interleaved variants of the bench step.

Counterpart of the JAX package's ``tools/abab.py``, which replaced its
per-round ``bench_r*`` one-offs. Every variant is ``tools.bench``'s
configuration plus zero or more modifiers, joined with '+':

    base            the shipped default (stacked storage, the fused
                    backward with K3, the CIN chain K1/K2)
    nochain         layers.cin.CIN_CHAIN_MODE = "off" (K4 and K5 per layer)
    pertable        per-table (V, k) leaves instead of stacked storage
    scatter         the sorted scatter backward of the lookups
                    (ops.embedding.grad_kernel("scatter"))
    uN              N steps a call of the unrolled step (default 1)
    bN              batch size N (default 8192)
    dp              the explicit DP step on a one-rank world
                    (parallel.train_explicit.make_dp_train_step_explicit;
                    composes with pertable, nochain and uN)
    gspmd           the row-sharded route's ShardedTrainer step on a
                    one-rank mesh (one step a call)
    savefm/nosavefm ops.cin_chain.CHAIN_SAVE_FMAPS on/off (the forward
                    writes the fmaps, or K2 rebuilds them)
    bf16m           the adam_bf16m optimizer (a bf16 first moment: it
                    shifts the numbers, so a flip needs the quality gates)

The reference's ctfN, ctbN, tvN and ccN set Pallas tile widths that the
port does not have; they are refused.

Method: each variant is built and warmed once; then ``--rounds``
interleaved windows of ``--steps`` steps run A, B, A, B, ...; each
window reads the device time of every call (CUDA events between calls)
and the host clock around the window, and the summary gives each
variant's median device ms and wall ms a step.

The port reads its routes when the forward runs, not when a step is
traced: autograd runs a CUDA backward on its own thread, and the
thread-local contexts are read in the forward. So a variant's flags and
contexts are applied around every call of its step, and the shipped
defaults are put back after each call, before the next variant's window.

Run from the repository root on a machine with a CUDA GPU:

    python -m recman_tpu_torch.tools.abab --variants base,base+nochain
    python -m recman_tpu_torch.tools.abab --variants base,pertable+u8
    python -m recman_tpu_torch.tools.abab --variants base --rounds 1 --steps 32
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import torch

from . import bench

# the shipped values of the module flags a variant sets
SHIPPED_CIN_CHAIN_MODE = "auto"
SHIPPED_CHAIN_SAVE_FMAPS = True
REFUSED = ("ctf", "ctb", "tv", "cc")


def parse_variant(name: str) -> dict:
    """A variant's settings from its modifiers (raises on an unknown or a
    refused modifier)."""
    spec = {"stacked": True, "chain": SHIPPED_CIN_CHAIN_MODE, "kernel": "auto",
            "mode": "local", "save_fmaps": SHIPPED_CHAIN_SAVE_FMAPS, "unroll": None,
            "batch": None, "optimizer": "adam"}
    for m in name.split("+"):
        if m == "base":
            continue
        if m == "nochain":
            spec["chain"] = "off"
        elif m == "chain":
            spec["chain"] = "auto"
        elif m == "pertable":
            spec["stacked"] = False
        elif m == "scatter":
            spec["kernel"] = "scatter"
        elif m == "dp":
            spec["mode"] = "dp"
        elif m == "gspmd":
            spec["mode"], spec["unroll"] = "gspmd", 1
        elif m in ("savefm", "nosavefm"):
            spec["save_fmaps"] = m == "savefm"
        elif m == "bf16m":
            spec["optimizer"] = "adam_bf16m"
        elif m[:1] in "ub" and m[1:].isdigit() and int(m[1:]) > 0:
            spec["unroll" if m[0] == "u" else "batch"] = int(m[1:])
        elif any(m.startswith(p) and m[len(p):].isdigit() for p in REFUSED):
            raise ValueError(f"modifier {m!r} in variant {name!r} sets a Pallas tile width of "
                             "the JAX package (CHAIN_TILE_*, SEGMAT_TILE_V, SEGMAT_CHUNK_CAP); "
                             "the port's CUDA kernels have no such setting")
        else:
            raise ValueError(f"unknown modifier {m!r} in variant {name!r}")
    if spec["mode"] == "gspmd" and spec["unroll"] != 1:
        raise ValueError(f"variant {name!r}: the row-sharded step takes one step a call")
    return spec


@contextlib.contextmanager
def variant_flags(spec: dict):
    """The variant's module flags and route context around one call; the
    shipped values after it."""
    from ..layers import cin
    from ..ops import cin_chain
    from ..ops.embedding import grad_kernel

    cin.CIN_CHAIN_MODE = spec["chain"]
    cin_chain.CHAIN_SAVE_FMAPS = spec["save_fmaps"]
    try:
        with grad_kernel(spec["kernel"]):
            yield
    finally:
        cin.CIN_CHAIN_MODE = SHIPPED_CIN_CHAIN_MODE
        cin_chain.CHAIN_SAVE_FMAPS = SHIPPED_CHAIN_SAVE_FMAPS


def window_order(names, rounds: int) -> list:
    """(round, variant) of every timed window, in the order they run."""
    return [(r, n) for r in range(rounds) for n in names]


class Variant:
    """A built variant: ``call(i)`` runs its i-th call (``unroll`` steps)
    under its flags and returns the losses."""

    def __init__(self, spec, setup, default_unroll, default_batch, device):
        from ..parallel import ShardedTrainer, make_mesh
        from ..parallel.train_explicit import make_dp_train_step_explicit
        from ..training import (
            TrainState,
            create_optimizer,
            init_state,
            make_train_step_stacked,
            make_train_step_unrolled,
            stack_table_params,
        )

        model, self.data, self.layout, n_rows = setup
        self.spec = spec
        self.unroll = spec["unroll"] or default_unroll
        self.batch = spec["batch"] or default_batch
        self.idx = bench.bench_batches(n_rows, self.batch, device)
        opt = create_optimizer(spec["optimizer"], bench.LEARNING_RATE)
        mode = spec["mode"]
        if mode == "gspmd":
            mesh = make_mesh(data=1, model=1, device=device)
            self.trainer = ShardedTrainer(
                model, {"optimizer": spec["optimizer"], "learning_rate": bench.LEARNING_RATE},
                batch_size=self.batch, mesh=mesh, spmd="gspmd", device=device)
            self.state = None
            self.step = None
            return
        state = init_state(model, opt, torch.Generator().manual_seed(0), device=device)
        names = None
        if spec["stacked"]:
            params, names = stack_table_params(model, state.params)
            state = TrainState(params, opt.init(params), state.step, state.generator)
        if mode == "dp":
            mesh = make_mesh(data=1, model=1, device=device)
            self.step = make_dp_train_step_explicit(model, opt, mesh, self.unroll,
                                                    stacked_names=names)
        elif names:
            self.step = make_train_step_stacked(model, opt, self.unroll, names)
        else:
            self.step = make_train_step_unrolled(model, opt, self.unroll)
        self.state = state

    def call(self, i):
        n = len(self.idx)
        rows = [(i * self.unroll + t) % n for t in range(self.unroll)]
        with variant_flags(self.spec):
            if self.step is None:
                return self.trainer.fit_on_batch(self.data, self.idx[rows[0]], self.layout)[None]
            self.state, losses = self.step(self.state, self.data, self.idx[rows], self.layout)
            return losses


def main(variants="base,base+nochain", rounds=4, steps=64, unroll=1, batch=None, device=None,
         num_buckets=bench.NUM_BUCKETS, n_rows=bench.N_ROWS, hparams=None):
    """Build, warm and time the variants in turns; prints a line a window
    and the JSON summary, and returns the summary's dict."""
    import torch.distributed as dist

    names = [v.strip() for v in variants.split(",")]
    specs = {n: parse_variant(n) for n in names}  # every modifier checked before any build
    had_group = dist.is_available() and dist.is_initialized()
    model, data, layout, _ = bench.build_bench_setup(device, num_buckets, n_rows, hparams)
    device = next(iter(data.values())).device
    setup = (model, data, layout, n_rows)
    built = {}
    try:
        for name in names:
            t0 = time.perf_counter()
            v = built[name] = Variant(specs[name], setup, unroll, batch or bench.BATCH_SIZE,
                                      device)
            loss = float(v.call(0)[-1])
            bench.sync(device)
            print(f"variant {name}: built and warm in {time.perf_counter() - t0:.1f} s, "
                  f"last loss {loss:.6f}", flush=True)

        windows = {n: [] for n in names}
        for r, name in window_order(names, rounds):
            v = built[name]
            calls = max(steps // v.unroll, 1)
            v.call(1)
            bench.sync(device)
            before = bench.launch_counts(every=True)
            timer = bench.StepTimer(device)
            t0 = time.perf_counter()
            timer.mark()
            for i in range(calls):
                v.call(2 + i)
                timer.mark()
            bench.sync(device)
            wall = time.perf_counter() - t0
            after = bench.launch_counts(every=True)
            n_steps = calls * v.unroll
            w = {"round": r, "device_ms_per_step": statistics.median(timer.step_ms()) / v.unroll,
                 "wall_ms_per_step": wall * 1e3 / n_steps,
                 "examples_per_s": n_steps * v.batch / wall,
                 "launches_per_step": {k: (after[k] - before[k]) / n_steps for k in after}}
            windows[name].append(w)
            print(f"round {r} {name}: {w['examples_per_s']:,.0f} ex/s, device "
                  f"{w['device_ms_per_step']:.4f} ms/step, wall {w['wall_ms_per_step']:.4f} "
                  f"ms/step, launches/step {w['launches_per_step']}", flush=True)
    finally:
        if not had_group and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()

    summary = {"metric": "abab", "order": names, "rounds": rounds, "steps": steps,
               "variants": {}, "device": device.type, "card": bench.card_of(device)}
    for name in names:
        ws = windows[name]
        summary["variants"][name] = {
            "device_ms_per_step": statistics.median(w["device_ms_per_step"] for w in ws),
            "wall_ms_per_step": statistics.median(w["wall_ms_per_step"] for w in ws),
            "examples_per_s": statistics.median(w["examples_per_s"] for w in ws),
            "windows": ws,
        }
    print(json.dumps(summary), flush=True)
    return summary


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="base,base+nochain")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--unroll", type=int, default=1)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    main(args.variants, args.rounds, args.steps, args.unroll, args.batch, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
