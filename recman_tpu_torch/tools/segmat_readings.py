"""Readings of the segment-sum kernels K3, K6 and K7 on one CUDA GPU that
chip_smoke.py does not take: chip_smoke.py checks, times and profiles by
pass this checkout's kernels, and these read another checkout's and other
builds of the source beside them. Each reading is one JSON line on stdout.

- ``timing``: K3 at N 8192 and 65,536 and K7 at N 8192 on the sorted ids
  of synthetic Criteo rows (26 tables, V 100,001, C 17), beside
  ``scatter_add_`` and ``index_add_`` on the same inputs, then K6 beside
  ``index_add_`` at one of those tables and at the ML-100K genres ids. It
  goes through the wrappers of whichever checkout ``recman_tpu_torch`` is
  imported from, so ``cd <checkout> && PYTHONPATH=. python <this file>
  timing`` times another checkout's kernels in the same call.
- ``variants``: K3 and K7 built as ``VARIANTS`` lists them (chunks of
  128, 256 and 512 positions; the passes launched plainly, not as
  programmatic dependents; a write pass that stores only zeros, its
  floor), each but the floor held to the plain version and to two-call
  bit-equality, then timed in turns (A B C .., .. C B A) beside the
  wrapper. The reading fails where the build as it stands and the wrapper,
  the same code on the same inputs, differ by more than ``CONTROL_REL``.

The timer (CUDA events, median of back-to-back calls), the card line and
the inputs are chip_smoke.py's, from this file's checkout.

Run from the repository root:

    python -m recman_tpu_torch.tools.segmat_readings timing variants
"""

from __future__ import annotations

import ctypes
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROWS = {"K3 8192": 8192, "K3 65536": 65_536, "K7 8192": 8192}
CONTROL_REL = 0.1  # the build as it stands against the wrapper, of the wrapper's time


def emit(**kv):
    print(json.dumps(kv), flush=True)


@functools.cache
def smoke():
    """chip_smoke.py of this file's checkout, as a module (loaded by path:
    another checkout on PYTHONPATH holds a chip_smoke.py of its own)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def inputs(rows, device):
    """Sorted ids (26, rows) and (26, 17, rows) cotangents, as chip_smoke.py
    makes K3's."""
    cs = smoke()
    sids = torch.from_numpy(cs.criteo_ids(rows)).to(device)
    sg = torch.randn((sids.shape[0], cs.HPARAMS["embedding_size"] + 1, rows),
                     generator=torch.Generator().manual_seed(12)).to(device)
    return sids, sg


def timing():
    from recman_tpu_torch.ops import segment_matmul as sm

    cs = smoke()
    device = torch.device("cuda")
    v, k_emb, card = cs.NUM_BUCKETS + 1, cs.HPARAMS["embedding_size"], cs.card_line()
    for what, rows in ROWS.items():
        sids, sg = inputs(rows, device)
        t, c, n = sg.shape
        if what.startswith("K3"):
            ms = cs.cuda_time_ms(lambda: sm.segment_matmul_from_sorted_batched(sids, sg, v))
            idx = sids.long()[:, None, :].expand(t, c, n)
            lib = cs.cuda_time_ms(lambda: torch.zeros((t, c, v), device=device)
                                  .scatter_add_(2, idx, sg))
        else:
            ms = cs.cuda_time_ms(lambda: sm.segment_matmul_from_sorted_batched_vk(
                sids, sg, v, k_emb, c - k_emb))
            flat = (sids.long() + v * torch.arange(t, device=device)[:, None]).reshape(-1)
            rows_t = sg.transpose(1, 2).reshape(t * n, c).contiguous()
            lib = cs.cuda_time_ms(lambda: torch.zeros((t * v, c), device=device)
                                  .index_add_(0, flat, rows_t))
        emit(reading="timing", kernel=what, checkout=sm.__file__, ms=ms, library_ms=lib,
             card=card)
    # K6 as chip_smoke.py reads it: one Criteo table of the 8192 rows, and
    # the ML-100K genres ids of one train batch
    sids, _ = inputs(8192, device)
    genres = torch.from_numpy(np.sort(cs.ml_genres_ids()).astype(np.int32)).to(device)
    for what, ids, vocab, c in (("K6 criteo", sids[0], v, k_emb + 1), ("K6 genres", genres, 20, 9)):
        sg = torch.randn((ids.shape[0], c), generator=torch.Generator().manual_seed(13)).to(device)
        ms = cs.cuda_time_ms(lambda: sm.segment_matmul_from_sorted(ids, sg, vocab))
        lib = cs.cuda_time_ms(lambda: torch.zeros((vocab, c), device=device)
                              .index_add_(0, ids, sg))
        emit(reading="timing", kernel=what, checkout=sm.__file__, ms=ms, library_ms=lib,
             card=card)


# Builds of csrc/segment_matmul.cu that the "variants" reading compares:
# (name, (text, replacement) in the source or None). The zero write
# stores 0 for every element and is wrong on purpose: it reads the write
# pass's floor, a fill at the same stores.
LANE = "constexpr int kLanePos = 4;"
AS_BUILT = "chunk 128 (as built)"
VARIANTS = [
    (AS_BUILT, None),
    ("chunk 256", (LANE, "constexpr int kLanePos = 8;")),
    ("chunk 512", (LANE, "constexpr int kLanePos = 16;")),
    ("plain launches", ("cfg.numAttrs = 1;", "cfg.numAttrs = 0;")),
    ("zero write (floor)", ("    d4[q] = w;",
                            "    d4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);")),
]


def build_variant(index, edit):
    from recman_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC / "segment_matmul.cu").read_text()
    if edit:
        assert edit[0] in text, edit[0]
        text = text.replace(edit[0], edit[1])
    src = cuda_build.BUILD_DIR / f"segmat-variant{index}.cu"
    src.write_text(text)
    out = src.with_suffix(".so")
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def variant_calls(lib, k_emb):
    """K3 and K7 of one built variant, as functions of (sids, sg, v), with
    the wrapper's arguments and allocations."""
    lib.segment_matmul_scratch_floats.restype = ctypes.c_longlong
    lib.segment_matmul_scratch_floats.argtypes = [ctypes.c_int] * 4
    k3, k7 = lib.segment_matmul_sorted_batched, lib.segment_matmul_sorted_batched_vk
    k3.restype = k7.restype = ctypes.c_int
    k3.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    k7.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

    def scratch(t, c, n, v, device):
        return torch.empty(lib.segment_matmul_scratch_floats(t, c, n, v), device=device)

    def run_k3(sids, sg, v):
        t, c, n = sg.shape
        out = torch.empty((t, c, v), device=sg.device)
        err = k3(sids.data_ptr(), sg.data_ptr(), out.data_ptr(),
                 scratch(t, c, n, v, sg.device).data_ptr(), t, c, n, v,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"K3 variant: CUDA error {err}"
        return out

    def run_k7(sids, sg, v):
        t, c, n = sg.shape
        emb = torch.empty((t, v, k_emb), device=sg.device)
        vec = torch.empty((t, c - k_emb, v), device=sg.device)
        err = k7(sids.data_ptr(), sg.data_ptr(), emb.data_ptr(), vec.data_ptr(),
                 scratch(t, c, n, v, sg.device).data_ptr(), t, k_emb, c - k_emb, n, v,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"K7 variant: CUDA error {err}"
        return emb, vec

    return run_k3, run_k7


def variants():
    from recman_tpu_torch.ops import cuda_build
    from recman_tpu_torch.ops import segment_matmul as sm

    cs = smoke()
    device = torch.device("cuda")
    v, k_emb, card = cs.NUM_BUCKETS + 1, cs.HPARAMS["embedding_size"], cs.card_line()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = [build_variant(i, edit) for i, (_, edit) in enumerate(VARIANTS)]
    calls = {}
    for (name, _), (path, proc) in zip(VARIANTS, procs):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        calls[name] = variant_calls(ctypes.CDLL(str(path)), k_emb)
    failed = []
    for what, rows in ROWS.items():
        sids, sg = inputs(rows, device)
        is_k3 = what.startswith("K3")
        ref = sm.segment_matmul_reference(sids, sg, v)
        scale = ref.abs().max().item()
        if is_k3:
            fns = {"wrapper": lambda: sm.segment_matmul_from_sorted_batched(sids, sg, v)}
        else:
            fns = {"wrapper": lambda: sm.segment_matmul_from_sorted_batched_vk(
                sids, sg, v, k_emb, sg.shape[1] - k_emb)}
        for name, (run_k3, run_k7) in calls.items():
            fns[name] = lambda f=(run_k3 if is_k3 else run_k7): f(sids, sg, v)
        for name, fn in fns.items():
            if "floor" in name:
                continue
            got, again = fn(), fn()
            if not is_k3:  # K7's outputs in K3's layout, for the check only
                got, again = (torch.cat([e.transpose(1, 2), w], 1) for e, w in (got, again))
            err = (got - ref).abs().max().item()
            assert err <= 1e-5 * scale, f"{what} {name}: max|d| {err} > 1e-5 * {scale}"
            assert torch.equal(got == 0, ref == 0) and torch.equal(got, again), f"{what} {name}"
            del got, again
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            times[name].append(cs.cuda_time_ms(fns[name]))
        for name, ts in times.items():
            emit(reading="variants", kernel=what, variant=name, ms=ts, card=card)
        built, wrapper = (sum(times[k]) / 2 for k in (AS_BUILT, "wrapper"))
        if abs(built - wrapper) > CONTROL_REL * wrapper:
            failed.append(f"{what}: {AS_BUILT} {built:.4f} ms against the wrapper's "
                          f"{wrapper:.4f} ms")
        del ref
    if failed:
        raise RuntimeError("variants: the timing's control failed: " + "; ".join(failed))


def main(argv):
    readings = {"timing": timing, "variants": variants}
    for name in argv or ["timing"]:
        readings[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
