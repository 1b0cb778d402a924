#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (recman_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and the CUDA
toolkit (no JAX needed):

    python3 chip_smoke.py

Phases, each failing the script (non-zero exit) when it fails:

1. setup: the card (nvidia-smi name and power limit), torch/CUDA
   versions, TF32 off; build every kernel in recman_tpu_torch/csrc (one
   nvcc per source, started together).
2. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' full-width shapes and at a small test geometry, then
   timed (CUDA events, warm-up, median) beside the plain version, the
   least time the card could take for the same work and, where one
   PyTorch call computes the same function, that call: K1 without and
   with saved fmaps (cin_chain_fwd.cu), K2 (cin_chain_bwd.cu) on the
   full-width forward's fmaps, K3 (segment_matmul.cu) on the sorted ids
   of 8192 synthetic Criteo rows.
3. the serving slice end to end: full-width xDeepFM (26 hashed fields x
   100,000 buckets, k=16, CIN (100, 100), DNN (400, 400)) with random
   params from a seed, Predictor(batch_size=8192).predict on 65,536
   synthetic Criteo rows. Checks that K1 launched once per batch, that
   the predictions are finite and in (0, 1), and that the first batch
   matches the port's own CPU run. Then times steady predict calls and
   one batch's forward, and profiles a few forwards (device time by
   kernel, the card's busy share).
4. the training slice end to end: the same model in stacked table
   storage with Adam(1e-3), make_train_step_stacked on batches of 8192
   shuffled rows. Step 1's gradient of every param and the loss trace of
   the first steps are held against the same steps on the CPU (the
   port's plain path); then 32 timed steps on the card must launch K1,
   K2 and K3 once each per step with finite losses; then a profile of 3
   steps.

It prints a ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Without a GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

N_ROWS = 65_536
BATCH = 8192
NUM_BUCKETS = 100_000
HPARAMS = {
    "embedding_size": 16,
    "cin_cross_layer_units": (100, 100),
    "cin_dropout": (1, 1, 1),
    "deep_hidden_units": (400, 400),
    "deep_dropout": (1.0, 1.0, 1.0),
}
# K1 at the serving path's full-width shapes (H0, units, B, D), then at a
# small geometry of the tests
CHAIN_GEOMETRIES = {"full": (26, (100, 100), BATCH, 16), "small": (5, (6, 4), 64, 4)}
K1_TOL = 1e-3    # of max|ref|: same bf16 rounding both sides, f32 sum order differs
K2_TOL = 1e-3    # of max|ref|: gpre rounds to bf16 after f32 sums in another order
K3_TOL = 1e-5    # of max|ref|: f32 sums of up to 8192 terms in another order
PRED_TOL = 1e-4  # max |dp| between the GPU and the CPU run of the same batch
GRAD_TOL = 1e-3  # of max|ref| per param: step 1's gradient, GPU against CPU (K2's rounding)
TRACE_ABS, TRACE_REL = 6e-3, 0.01  # loss trace, GPU against CPU (bench.py:215's bounds)
CPU_STEPS = 4     # steps compared with the CPU
TIMED_STEPS = 32  # steps timed on the card


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup=3, reps=25):
    """Median device time of one fn() call over reps back-to-back calls.

    A CUDA event is recorded between consecutive calls and the host
    synchronises only at the end, so the host enqueues ahead of the card
    and each interval is the call's device time, not the host's overhead.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def chain_inputs(h0, units, b, d, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    x0c = torch.randn((h0, b * d), generator=g)
    ws, bs, hk = [], [], h0
    for o in units:
        ws.append(torch.randn((h0 * hk, o), generator=g) * (2.0 / (h0 * hk + o)) ** 0.5)
        bs.append(0.1 * torch.randn((o,), generator=g))
        hk = o // 2
    return x0c.to(device), [w.to(device) for w in ws], [v.to(device) for v in bs]


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    """Least time (ms) for work of ``flops`` operations and ``nbytes`` moved
    (each input read once, each output written once), and which bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def chain_bound_ms(x0c, ws, bs, outs):
    """Least time for K1's work (``outs``: the pooled blocks, and the fmaps
    when saving): bf16 products over the tensor-core peak, or the bytes."""
    bd = x0c.shape[1]
    flops = sum(2 * bd * w.shape[0] * w.shape[1] for w in ws)
    moved = nbytes(x0c, *ws, *bs, *outs)
    return (*bound(flops, moved), flops, moved)


def chain_bwd_bound_ms(x0c, ws, gs, fmaps, grads):
    """Least time for K2's work: dW and u each a bf16 product of the size
    of the forward's; bytes: x0c, W, the pooled cotangents and the fmaps
    in, dx0, dW and db out."""
    bd = x0c.shape[1]
    flops = sum(2 * 2 * bd * w.shape[0] * w.shape[1] for w in ws)
    moved = nbytes(x0c, *ws, *gs, *fmaps, grads[0], *grads[1], *grads[2])
    return (*bound(flops, moved), flops, moved)


def segmat_bound_ms(sids, sg, out):
    """Least time for K3's work: one f32 add per cotangent element (CUDA
    cores), or the ids and cotangents in and the dense grads out."""
    flops = sg.numel()
    moved = nbytes(sids, sg, out)
    return (*bound(flops, moved, PEAK_F32_FLOPS), flops, moved)


def max_rel_err(refs, gots, tol, what):
    """max |ref - got| over the pairs, each checked against tol * max|ref|."""
    worst = 0.0
    for i, (r, g) in enumerate(zip(refs, gots)):
        check(g.shape == r.shape, f"{what}[{i}] shape {tuple(g.shape)} vs {tuple(r.shape)}")
        err = (r - g).abs().max().item()
        scale = r.abs().max().item()
        check(err <= tol * scale, f"{what}[{i}]: max|d| {err} > {tol} * {scale}")
        worst = max(worst, err)
    return worst


def phase_kernels(device):
    """Every kernel against its plain version at the small and the full
    geometry, then timed at full width. Returns the kernels' records."""
    import numpy as np
    import torch

    from recman_tpu_torch.data import synthetic_criteo_arrays
    from recman_tpu_torch.ops import cin_chain, segment_matmul

    rec = {}
    for label, (h0, units, b, d) in CHAIN_GEOMETRIES.items():
        n = len(units)
        x0c, ws, bs = chain_inputs(h0, units, b, d, seed=7, device=device)
        for act in ("leaky_relu", "relu", "identity") if label == "small" else ("leaky_relu",):
            got = cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act)
            got_s = cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act, save=True)
            torch.cuda.synchronize()
            ref = cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act, save=True)
            e1 = max_rel_err(ref[:n], got, K1_TOL, f"K1 {label} {act}")
            e1s = max_rel_err(ref, got_s, K1_TOL, f"K1 save {label} {act}")
            g = torch.Generator().manual_seed(11)
            gs = [torch.randn(p.shape, generator=g).to(device) for p in ref[:n]]
            got_b = cin_chain.cin_chain_bwd(x0c, ws, bs, gs, got_s[n:], units, d, act)
            torch.cuda.synchronize()
            ref_b = cin_chain.cin_chain_bwd_reference(x0c, ws, bs, gs, got_s[n:], units, d, act)
            e2 = max_rel_err([ref_b[0], *ref_b[1], *ref_b[2]],
                             [got_b[0], *got_b[1], *got_b[2]], K2_TOL, f"K2 {label} {act}")
            log(f"K1/K1 save/K2 vs plain [{label} H0={h0} units={units} B={b} D={d} {act}]: "
                f"max|d| {e1:.3e} / {e1s:.3e} / {e2:.3e}; max|ref| pooled "
                f"{max(r.abs().max().item() for r in ref[:n]):.4g}, dx0 "
                f"{ref_b[0].abs().max().item():.4g}, dW {[round(w.abs().max().item(), 4) for w in ref_b[1]]}")
        if label != "full":
            continue
        act = "leaky_relu"
        ms = cuda_time_ms(lambda: cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act))
        plain_ms = cuda_time_ms(
            lambda: cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act), reps=20)
        bnd, by, flops, moved = chain_bound_ms(x0c, ws, bs, got)
        rec["K1"] = {"max_abs_err": e1, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                     "bound_by": by, "library_ms": None}
        log(f"K1 full width: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms "
            f"({by}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.2f} MB), "
            f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
        ms = cuda_time_ms(lambda: cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act, save=True))
        plain_ms = cuda_time_ms(lambda: cin_chain.cin_chain_fm_reference(
            x0c, ws, bs, units, d, act, save=True), reps=20)
        bnd, by, flops, moved = chain_bound_ms(x0c, ws, bs, got_s)
        rec["K1 save"] = {"max_abs_err": e1s, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                          "bound_by": by, "library_ms": None}
        log(f"K1 save full width: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms "
            f"({by}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.2f} MB)")
        fm = got_s[n:]
        ms = cuda_time_ms(lambda: cin_chain.cin_chain_bwd(x0c, ws, bs, gs, fm, units, d, act))
        plain_ms = cuda_time_ms(lambda: cin_chain.cin_chain_bwd_reference(
            x0c, ws, bs, gs, fm, units, d, act), reps=20)
        bnd, by, flops, moved = chain_bwd_bound_ms(x0c, ws, gs, fm, got_b)
        rec["K2"] = {"max_abs_err": e2, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                     "bound_by": by, "library_ms": None}
        log(f"K2 full width: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms "
            f"({by}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.2f} MB), "
            f"{flops / ms / 1e9:.1f} TFLOP/s achieved")

    # K3: a small Zipf case, then the full-width sorted ids of one batch
    rs = np.random.RandomState(3)
    small_ids = np.sort(np.minimum(rs.zipf(1.2, size=(3, 70)) + 1, 49).astype(np.int32), axis=1)
    data = synthetic_criteo_arrays(BATCH, num_buckets=NUM_BUCKETS, seed=2019)
    from recman_tpu_torch.data import CAT_NAMES

    full_ids = np.sort(np.stack([data[c] for c in CAT_NAMES]).astype(np.int32), axis=1)
    vocab_full = NUM_BUCKETS + 1
    for label, ids, v in (("small", small_ids, 50), ("full", full_ids, vocab_full)):
        t, nn = ids.shape
        c = 5 if label == "small" else HPARAMS["embedding_size"] + 1
        sids = torch.from_numpy(ids).to(device)
        sg = torch.randn((t, c, nn), generator=torch.Generator().manual_seed(12)).to(device)
        got = segment_matmul.segment_matmul_from_sorted_batched(sids, sg, v)
        torch.cuda.synchronize()
        ref = segment_matmul.segment_matmul_reference(sids, sg, v)
        e3 = max_rel_err([ref], [got], K3_TOL, f"K3 {label}")
        check(torch.equal(got == 0, ref == 0), f"K3 {label}: zeros differ from the plain version")
        longest = max(int(torch.unique_consecutive(r, return_counts=True)[1].max()) for r in sids)
        log(f"K3 vs plain [{label} T={t} C={c} N={nn} V={v}]: max|d| {e3:.3e}, "
            f"max|ref| {ref.abs().max().item():.4g}, empty columns exact; longest run "
            f"of one id {longest} of {nn}")
    ms = cuda_time_ms(lambda: segment_matmul.segment_matmul_from_sorted_batched(sids, sg, v))
    plain_ms = cuda_time_ms(lambda: segment_matmul.segment_matmul_reference(sids, sg, v), reps=20)
    idx = sids.long()[:, None, :].expand(t, c, nn)
    lib_ms = cuda_time_ms(lambda: torch.zeros((t, c, v), device=device).scatter_add_(2, idx, sg))
    bnd, by, flops, moved = segmat_bound_ms(sids, sg, got)
    rec["K3"] = {"max_abs_err": e3, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                 "bound_by": by, "library_ms": lib_ms}
    log(f"K3 full width: {ms:.4f} ms, plain {plain_ms:.4f} ms, library (scatter_add_) "
        f"{lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}; {moved / 1e6:.2f} MB), "
        f"{moved / ms / 1e6:.1f} GB/s achieved")
    return rec


def phase_serving(device):
    import numpy as np
    import torch

    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.ops import cin_chain
    from recman_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    model = XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), HPARAMS)
    params = model.init_params(torch.Generator().manual_seed(0))  # default device: CUDA
    check(all(v.is_cuda for v in params.values()), "params not on the GPU")
    data = synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=2019)
    data.pop("y")
    predictor = Predictor(model, params, batch_size=BATCH)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    log(f"setup: {n_params} params ({4 * n_params / 1e6:.1f} MB f32), "
        f"{N_ROWS} rows, {time.perf_counter() - t0:.2f} s")

    n_batches = N_ROWS // BATCH + 1
    cin_chain.LAUNCHES = 0
    t0 = time.perf_counter()
    preds = predictor.predict(data)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cin_chain.LAUNCHES
    check(launches == n_batches, f"K1 launched {launches} times for {n_batches} batches")
    check(preds.shape == (N_ROWS,), f"predictions shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), "non-finite predictions")
    check(bool(((preds > 0) & (preds < 1)).all()), "predictions outside (0, 1)")
    log(f"predict (first call): {first_s:.3f} s; K1 launches {launches} = batches {n_batches}; "
        f"preds mean {preds.mean():.6f} std {preds.std():.6f}")

    # the same params and first batch on the CPU
    params_cpu = {k: v.cpu() for k, v in params.items()}
    batch_cpu = {k: torch.as_tensor(v[:BATCH]) for k, v in data.items()}
    t0 = time.perf_counter()
    with torch.inference_mode():
        preds_cpu = model.apply(params_cpu, batch_cpu).numpy()
    cpu_s = time.perf_counter() - t0
    dp = float(np.abs(preds_cpu - preds[:BATCH]).max())
    check(dp <= PRED_TOL, f"GPU vs CPU first batch: max|dp| {dp} > {PRED_TOL}")
    log(f"GPU vs CPU, first batch of {BATCH}: max|dp| {dp:.3e} (CPU forward {cpu_s:.2f} s)")

    # steady state: whole predict calls (host encode-free arrays -> device,
    # 9 batches, results back) and the device time of one batch's forward
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        predictor.predict(data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    dev = {k: torch.as_tensor(v[:BATCH]).cuda() for k, v in data.items()}
    override = torch.as_tensor(model.linear.override_vector()).cuda()

    def forward():
        with torch.inference_mode():
            return model.apply(predictor.params, dev, linear_override=override)

    batch_ms = cuda_time_ms(forward, reps=20)
    log(f"predict steady: {wall * 1e3:.3f} ms per call of {N_ROWS} rows "
        f"({wall * 1e3 / n_batches:.3f} ms per batch incl. padding batch), "
        f"{N_ROWS / wall:.1f} examples/s; one batch forward (device) {batch_ms:.4f} ms, "
        f"{BATCH / batch_ms * 1e3:.1f} examples/s")
    profile_device(forward, batch_ms, "batch forwards")
    return launches


def profile_device(fn, unit_ms, what, n=5):
    """Device time by kernel over n calls of fn, and the card's busy share:
    kernel time per call over the call's device time measured without the
    profiler (which slows the host and so idles the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernel_ms = sum(e.self_device_time_total for e in averages
                    if e.device_type == DeviceType.CUDA) / 1e3 / n
    log(f"profile of {n} {what}: kernels {kernel_ms:.4f} ms per call, busy share "
        f"{kernel_ms / unit_ms:.4f} of {unit_ms:.4f} ms" if kernel_ms else
        f"profile of {n} {what}: no device time traced (busy share not measured)")
    table = averages.table(sort_by="self_cuda_time_total", row_limit=16, max_name_column_width=60)
    log("\n".join(table.splitlines()[:20]))


def phase_training(device):
    """The stacked train step at full width: GPU against the port's CPU
    run, then timed. Returns the launches of the timed run per kernel."""
    import numpy as np
    import torch

    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.ops import cin_chain, segment_matmul
    from recman_tpu_torch.serving import batch_indices
    from recman_tpu_torch.training import (
        TrainState, create_optimizer, gather_batch, make_train_step_stacked, pack_dataset,
        stack_table_params, unpack_batch,
    )
    from recman_tpu_torch.training.train_step import loss_and_grads

    t0 = time.perf_counter()
    model = XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), HPARAMS)
    opt = create_optimizer("adam", 1e-3)
    params, names = stack_table_params(
        model, model.init_params(torch.Generator().manual_seed(0)))  # default device: CUDA
    check(all(v.is_cuda for v in params.values()), "params not on the GPU")
    packed, layout = pack_dataset(synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=2019))
    idx_np = batch_indices(N_ROWS, BATCH, shuffle_seed=0)
    idx_np = idx_np[(idx_np >= 0).all(axis=1)]  # drop the all-padding batch, as bench.py does
    data = {k: torch.as_tensor(v).to(device) for k, v in packed.items()}
    idx = torch.as_tensor(idx_np).to(device)
    torch.cuda.synchronize()
    log(f"training setup: stacked leaf {tuple(params['__stacked_feat_embed'].shape)}, "
        f"{len(idx_np)} batches of {BATCH}, {time.perf_counter() - t0:.2f} s")

    def first_grads(p, d, ix):
        batch, w = gather_batch(d, ix[0])
        return loss_and_grads(model, p, unpack_batch(batch, layout), w, names=names)

    def trace(p, d, ix):
        state = TrainState(p, opt.init(p), 0, None)
        state, losses = make_train_step_stacked(model, opt, CPU_STEPS, names)(state, d, ix, layout)
        return state, losses

    # the same first steps on the card and on the CPU, from the same params
    params_cpu = {k: v.cpu() for k, v in params.items()}
    data_cpu = {k: torch.as_tensor(v) for k, v in packed.items()}
    idx_cpu = torch.as_tensor(idx_np)
    loss_g, grads_g = first_grads(params, data, idx)
    _, trace_g = trace(params, data, idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_c, grads_c = first_grads(params_cpu, data_cpu, idx_cpu)
    _, trace_c = trace(params_cpu, data_cpu, idx_cpu)
    cpu_s = time.perf_counter() - t0
    rel = {}
    for k in grads_c:
        err = (grads_g[k].cpu() - grads_c[k]).abs().max().item()
        scale = grads_c[k].abs().max().item()
        rel[k] = err / scale if scale else err
        check(err <= GRAD_TOL * scale, f"step-1 grad {k}: GPU vs CPU max|d| {err} > {GRAD_TOL} * {scale}")
    tg, tc = trace_g.cpu().numpy(), trace_c.numpy()
    max_d = float(np.abs(tg - tc).max())
    final_rel = float(abs(tg[-1] - tc[-1]) / max(abs(tc[-1]), 1e-9))
    check(np.isfinite(tg).all() and np.isfinite(tc).all(), "non-finite loss")
    check(max_d <= TRACE_ABS and final_rel <= TRACE_REL,
          f"loss trace GPU vs CPU: max|d| {max_d} (bound {TRACE_ABS}), final rel {final_rel} "
          f"(bound {TRACE_REL})")
    worst = max(rel, key=rel.get)
    log(f"training GPU vs CPU (CPU {CPU_STEPS} steps + step-1 grads in {cpu_s:.1f} s): step-1 loss "
        f"{loss_g.item():.7f} vs {loss_c.item():.7f}; grads max|d|/max|ref| worst {rel[worst]:.3e} "
        f"({worst}), stacked leaf {rel['__stacked_feat_embed']:.3e}; trace GPU {tg.tolist()} "
        f"CPU {tc.tolist()}: max|d| {max_d:.3e}, final rel {final_rel:.3e}")

    # timed: TIMED_STEPS single steps on the card, counts from 0
    step = make_train_step_stacked(model, opt, 1, names)
    state = TrainState(params, opt.init(params), 0, None)
    for i in range(3):  # warm-up
        state, _ = step(state, data, idx[i:i + 1], layout)
    torch.cuda.synchronize()
    cin_chain.LAUNCHES = cin_chain.BWD_LAUNCHES = segment_matmul.LAUNCHES = 0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TIMED_STEPS):
        j = i % len(idx_np)
        state, loss = step(state, data, idx[j:j + 1], layout)
        losses.append(loss)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": cin_chain.LAUNCHES, "K2": cin_chain.BWD_LAUNCHES, "K3": segment_matmul.LAUNCHES}
    for name, count in launches.items():
        check(count == TIMED_STEPS, f"{name} launched {count} times in {TIMED_STEPS} steps")
    losses = torch.cat(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), "non-finite loss in the timed steps")
    step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    log(f"train steady: {TIMED_STEPS} steps, launches {launches}; step (device, median) "
        f"{step_ms:.4f} ms, {BATCH / step_ms * 1e3:.1f} examples/s; wall {wall * 1e3 / TIMED_STEPS:.3f} "
        f"ms/step, {TIMED_STEPS * BATCH / wall:.1f} examples/s; loss first {losses[0]:.6f} "
        f"last {losses[-1]:.6f}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    box = {"state": state}

    def one_step():
        box["state"], _ = step(box["state"], data, idx[:1], layout)

    profile_device(one_step, step_ms, "train steps", n=3)
    return launches


def kernel_record(name, source, replaces, launches, rec):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "kernel_ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available; nothing to run", file=sys.stderr)
        return 1
    from recman_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must be off")
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    logs = cuda_build.build()
    log(f"built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    device = torch.device("cuda")
    rec = phase_kernels(device)
    t0 = time.perf_counter()
    serve_k1 = phase_serving(device)
    log(f"serving phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train = phase_training(device)
    log(f"training phase {time.perf_counter() - t0:.1f} s")

    fwd, bwd, seg = ("recman_tpu_torch/csrc/cin_chain_fwd.cu", "recman_tpu_torch/csrc/cin_chain_bwd.cu",
                     "recman_tpu_torch/csrc/segment_matmul.cu")
    kernels = [
        kernel_record("cin_chain_fwd", fwd, "recman_tpu/ops/cin_chain.py:218", serve_k1, rec["K1"]),
        kernel_record("cin_chain_fwd_save", fwd, "recman_tpu/ops/cin_chain.py:218",
                      train["K1"], rec["K1 save"]),
        kernel_record("cin_chain_bwd", bwd, "recman_tpu/ops/cin_chain.py:249", train["K2"], rec["K2"]),
        kernel_record("segment_matmul", seg, "recman_tpu/ops/embedding.py:405", train["K3"], rec["K3"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
