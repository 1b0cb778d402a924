"""Readings of the segment-sum kernels K3, K6 and K7 on one CUDA GPU that
chip_smoke.py does not take: chip_smoke.py checks, times and profiles by
pass this checkout's kernels, and these read another checkout's and other
builds of the source beside them. Each reading is one JSON line on stdout.

- ``timing``: K3 at N 8192 and 65,536 and K7 at N 8192 on the sorted ids
  of synthetic Criteo rows (26 tables, V 100,001, C 17), beside
  ``scatter_add_`` and ``index_add_`` on the same inputs, then K6 beside
  ``index_add_`` at one of those tables, at the ML-100K genres ids and at
  the table's ids with V 246,000 and 1,000,001 (outputs of 16.7 and 68 MB,
  inside and past the L2 cache), with what a call of each costs the host
  (``host_ms``). It
  goes through the wrappers of whichever checkout ``recman_tpu_torch`` is
  imported from, so ``cd <checkout> && PYTHONPATH=. python <this file>
  timing`` times another checkout's kernels in the same call.
- ``variants``: K3, K7 and K6 built as ``VARIANTS`` lists them (chunks
  of 128, 256 and 512 positions; the passes launched plainly, not as
  programmatic dependents; K6's one launch at 4 blocks an SM; a write
  pass that stores only zeros, the floor of K3's and K7's write),
  each but the floor held to the plain version and to two-call
  bit-equality, then timed in turns (A B C .., .. C B A) beside the
  wrapper; K6 also beside K7 at T = 1 on the transposed cotangents, the
  transpose included. The reading fails where the build as it stands and
  the wrapper, the same code on the same inputs, differ by more than
  ``CONTROL_REL`` for K3 or K7 (K6's readings are mostly the host's, and
  the wrapper's checks are part of them).

The timer (CUDA events, median of back-to-back calls), the card line and
the inputs are chip_smoke.py's, from this file's checkout.

- ``phases``: K6's one launch built with ``%globaltimer`` stamps at its
  start, its barriers and its end, at K6's inputs: the time of each phase
  in ns (the first two calls of seven dropped), and with one barrier more,
  a barrier's cost.

Run from the repository root:

    python -m recman_tpu_torch.tools.segmat_readings timing variants phases
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


def k6_inputs(device):
    """K6's inputs as chip_smoke.py makes them: (label, sorted ids (N,),
    V, (N, C) cotangents) at one Criteo table of the 8192 rows and at the
    ML-100K genres ids of one train batch; then the table's ids with V
    246,000 and 1,000,001, outputs inside and past the L2 cache."""
    cs = smoke()
    sids, _ = inputs(8192, device)
    genres = torch.from_numpy(np.sort(cs.ml_genres_ids()).astype(np.int32)).to(device)
    k = cs.HPARAMS["embedding_size"] + 1
    for what, ids, vocab, c in (("K6 criteo", sids[0].contiguous(), cs.NUM_BUCKETS + 1, k),
                                ("K6 genres", genres, 20, 9),
                                # outputs of 16.7 and 68 MB: inside and past the L2 cache
                                ("K6 V 246,000", sids[0].contiguous(), 246_000, k),
                                ("K6 V 1,000,001", sids[0].contiguous(), 1_000_001, k)):
        sg = torch.randn((ids.shape[0], c), generator=torch.Generator().manual_seed(13)).to(device)
        yield what, ids, vocab, sg


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
    for what, ids, vocab, sg in k6_inputs(device):
        k6 = functools.partial(sm.segment_matmul_from_sorted, ids, sg, vocab)

        def lib_call():
            return torch.zeros((vocab, sg.shape[1]), device=device).index_add_(0, ids, sg)

        emit(reading="timing", kernel=what, checkout=sm.__file__, ms=cs.cuda_time_ms(k6),
             library_ms=cs.cuda_time_ms(lib_call), host_ms=cs.host_time_ms(k6),
             library_host_ms=cs.host_time_ms(lib_call), card=card)


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
    ("K6 at 4 blocks an SM", ("constexpr int kRowsBlocksPerSm = 2;",
                              "constexpr int kRowsBlocksPerSm = 4;")),
]


def build_variant(index, edit, extra=()):
    """Starts nvcc on csrc/segment_matmul.cu with the edit (text,
    replacement) and the ``extra`` edits made; returns the library's path
    and the process."""
    from recman_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC / "segment_matmul.cu").read_text()
    for old, new in ([edit] if edit else []) + list(extra):
        assert old in text, old
        text = text.replace(old, new)
    src = cuda_build.BUILD_DIR / f"segmat-variant{index}.cu"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    out = src.with_suffix(".so")
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def variant_calls(lib, k_emb):
    """K3, K7 and K6 of one built variant, as functions of (sids, sg, v),
    with the wrappers' arguments and allocations."""
    lib.segment_matmul_scratch_floats.restype = ctypes.c_longlong
    lib.segment_matmul_scratch_floats.argtypes = [ctypes.c_int] * 4
    k3, k7 = lib.segment_matmul_sorted_batched, lib.segment_matmul_sorted_batched_vk
    k6 = lib.segment_matmul_sorted_rows
    lib.segment_matmul_rows_scratch_floats.restype = ctypes.c_longlong
    lib.segment_matmul_rows_scratch_floats.argtypes = [ctypes.c_int] * 3
    k3.restype = k7.restype = k6.restype = ctypes.c_int
    k3.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    k7.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    k6.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

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

    def run_k6(sids, sg, v):
        n, c = sg.shape
        out = torch.empty((v, c), device=sg.device)
        rows_scratch = torch.empty(lib.segment_matmul_rows_scratch_floats(c, n, v),
                                   device=sg.device)
        err = k6(sids.data_ptr(), sg.data_ptr(), out.data_ptr(), rows_scratch.data_ptr(), c, n,
                 v, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"K6 variant: CUDA error {err}"
        return out

    return {"K3": run_k3, "K7": run_k7, "K6": run_k6}


def k3_layout(out):
    """K7's outputs in K3's layout, for the check only."""
    emb, vec = out
    return torch.cat([emb.transpose(1, 2), vec], 1)


def in_turns(what, fns, ref, card, failed, to_ref_layout=None):
    """Holds every function but the floor to ref (through
    ``to_ref_layout``) and to two-call bit-equality, times them in turns
    and emits the readings; appends to ``failed`` where the build as it
    stands and the wrapper differ by more than CONTROL_REL."""
    cs = smoke()
    scale = ref.abs().max().item()
    for name, fn in fns.items():
        if "floor" in name:
            continue
        got, again = fn(), fn()
        if to_ref_layout:
            got, again = to_ref_layout(got), to_ref_layout(again)
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
        kernel = what.split()[0]
        ref = sm.segment_matmul_reference(sids, sg, v)
        if kernel == "K3":
            fns = {"wrapper": lambda: sm.segment_matmul_from_sorted_batched(sids, sg, v)}
        else:
            fns = {"wrapper": lambda: sm.segment_matmul_from_sorted_batched_vk(
                sids, sg, v, k_emb, sg.shape[1] - k_emb)}
        for name, runs in calls.items():
            fns[name] = lambda f=runs[kernel]: f(sids, sg, v)
        in_turns(what, fns, ref, card, failed, k3_layout if kernel == "K7" else None)
        del ref
    for what, ids, vocab, sg in k6_inputs(device):
        c = sg.shape[1]
        ref = sm.segment_matmul_rows_reference(ids, sg, vocab)
        fns = {"wrapper": lambda: sm.segment_matmul_from_sorted(ids, sg, vocab),
               "transpose + K7": lambda: sm.segment_matmul_from_sorted_batched_vk(
                   ids[None], sg.t().contiguous()[None], vocab, c, 0)[0][0]}
        for name, runs in calls.items():
            fns[name] = lambda f=runs["K6"]: f(ids, sg, vocab)
        # K6's readings are the host's where its output is small, and the
        # wrapper's checks are part of them: no control
        in_turns(what, fns, ref, card, [])
    if failed:
        raise RuntimeError("variants: the timing's control failed: " + "; ".join(failed))


# K6's one launch with %globaltimer stamps: block 0's thread 0 at its start
# (0) and after each barrier (1, 2), each block's thread 0 at its end (3,
# the latest kept); PHASE_BARRIER adds one more barrier after the first
# (stamp 4 after it), whose cost is then 4 - 1.
_SCATTER = "    if (id >= 0 && id < v) out[(size_t)id * c + row] = sc.rec[(size_t)row * sc.slots + slot];\n  }\n"
_TASKS = "  const long long tasks = (long long)sc.chunks * ((c + kRowsInFlight - 1) / kRowsInFlight);\n  for"
_ZEROS = "  clear_words(reinterpret_cast<unsigned*>(out), (long long)v * c, i, threads);\n  grid.sync();\n"
_FIXUP = "fix_row(c, sc, (int)row);\n    grid.sync();\n"
PHASE_STAMPS = [
    ("constexpr unsigned kFull = 0xffffffffu;\n",
     "constexpr unsigned kFull = 0xffffffffu;\n__device__ unsigned long long g_stamp[8];\n"
     "__device__ __forceinline__ unsigned long long now_ns() {\n"
     "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n__device__ __forceinline__ void stamp(int k) {\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[k] = now_ns();\n}\n"),
    (_TASKS, "  stamp(0);\n" + _TASKS),
    (_ZEROS, _ZEROS + "  stamp(1);\n"),
    (_FIXUP, _FIXUP + "    stamp(2);\n"),
    (_SCATTER, _SCATTER + "  __syncthreads();\n  if (threadIdx.x == 0) atomicMax(&g_stamp[3], now_ns());\n"),
    ("}  // namespace\n",
     "}  // namespace\nextern \"C\" int segmat_stamps(unsigned long long* out, int reset) {\n"
     "  unsigned long long zero[8] = {0};\n"
     "  return (int)(reset ? cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero))\n"
     "                     : cudaMemcpyFromSymbol(out, g_stamp, sizeof(zero)));\n}\n"),
]
PHASE_BARRIER = (_ZEROS + "  stamp(1);\n", _ZEROS + "  stamp(1);\n  grid.sync();\n  stamp(4);\n")


def phases():
    """K6's phases inside its one launch at K6's inputs, in ns: the sums and
    zeros (to the first barrier's end), the fix-up (to the second's), the
    scatter, and the barrier's own cost from the build with one more."""
    from recman_tpu_torch.ops import segment_matmul as sm

    cs = smoke()
    device = torch.device("cuda")
    builds = {}
    for i, (name, edit) in enumerate((("as built", None), ("one more barrier", PHASE_BARRIER))):
        path, proc = build_variant(f"-phases{i}", None, PHASE_STAMPS + ([edit] if edit else []))
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the phases build {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.segmat_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        builds[name] = (lib, variant_calls(lib, cs.HPARAMS["embedding_size"])["K6"])
    for what, ids, vocab, sg in k6_inputs(device):
        ref = sm.segment_matmul_rows_reference(ids, sg, vocab)
        for name, (lib, run) in builds.items():
            rows = []
            for _ in range(7):
                stamps = (ctypes.c_ulonglong * 8)()
                assert lib.segmat_stamps(None, 1) == 0
                got = run(ids, sg, vocab)
                torch.cuda.synchronize()
                assert lib.segmat_stamps(stamps, 0) == 0
                t = list(stamps)
                after_first = t[4] or t[1]
                rows.append({"sums_zeros": t[1] - t[0], "barrier": t[4] - t[1] if t[4] else None,
                             "fixup": t[2] - after_first if t[2] else 0,
                             "scatter": t[3] - (t[2] or after_first), "total": t[3] - t[0]})
            assert (got - ref).abs().max() <= 1e-5 * ref.abs().max(), f"{what} {name}"
            emit(reading="phases", kernel=what, build=name, ns=rows[2:], card=cs.card_line())


def main(argv):
    readings = {"timing": timing, "variants": variants, "phases": phases}
    for name in argv or ["timing"]:
        readings[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
