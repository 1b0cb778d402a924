"""The port's CUDA kernels against their plain PyTorch versions on the same
CUDA tensors. These need a GPU (the kernels have no CPU or interpret
mode) and skip without one; run them on a machine with a GPU and the CUDA
toolkit. ``--noconftest`` skips tests/conftest.py, which imports JAX, so
JAX need not be installed there:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

Tolerances, per tensor, of its largest element:

- K1 (pooled blocks and saved fmaps) 1e-3: both sides round x0, xk, z and
  W to bf16 at the same places; only the order of the f32 sums differs.
  Held so twice: end to end, and layer by layer against the plain version
  run on K1's own feed rows (``feeds``). Sums in another order round a
  feed element to the neighbouring bf16 value now and then, which the
  next layers carry; where that puts two f32 orders more than 1e-3 apart
  end to end, ``K1_E2E_TOL`` gives the geometry's limit, set from
  readings of both against the exact (f64) chain.
- K2 (dx0, dW_i, db_i) 1e-3: gpre is rounded to bf16 after f32 sums whose
  order differs, so an element can land one bf16 step away.
- K4 (pre) and K5 (dx0, dxk, dW) 1e-3: the same bf16 roundings of z, W
  and g on both sides, f32 sums in another order; K5 bit-equal on two
  calls (no atomics).
- The CIN layer's per-layer path, card against CPU: 1e-4 forward.
- K2's recompute form: bit-equal to the save form (its phase 0 rebuilds
  the fmaps with K1's own code), and 1e-3 of its plain version (K2's
  twin on K1's fmaps, which are held to K1's twin as above, with the
  elements of other sign at most 1e-5 of them, or one, each within 1e-5
  of max|ref| of 0), at every batch.
- K3, K6 and K7 1e-5, and exact zeros where no id falls: f32 sums of the
  same terms in another order; each bit-equal on two calls (no atomics),
  K7 bit-equal to K3 and K6 to K7 at one table (the same sums).
- A CUDA serving artifact against the live predictor: 1e-6 (the same
  kernels on the same rows); a portable artifact traced on the CPU and
  served on the card against the CPU: 1e-5 (f32 sums in another order).
- One stacked train step, GPU against CPU: loss 1e-5 relative, every
  gradient 1e-3 (the K2 rounding above); one ML-100K step of each
  FM-family model, DCN, DIN, BST and DIEN the same (K6's f32 sums in
  another order, the DNN's relu read on either side of 0).
"""

import numpy as np
import pytest
import torch

from recman_tpu_torch.ops import cin_chain, cin_interact, segment_matmul

ACTS = ["identity", "relu", "leaky_relu"]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _inputs(h0, units, b, d, seed, device):
    g = torch.Generator().manual_seed(seed)
    x0c = torch.randn((h0, b * d), generator=g)
    ws, bs, hk = [], [], h0
    for o in units:
        ws.append(torch.randn((h0 * hk, o), generator=g) * (2.0 / (h0 * hk + o)) ** 0.5)
        bs.append(0.1 * torch.randn((o,), generator=g))
        hk = o // 2
    return x0c.to(device), [w.to(device) for w in ws], [v.to(device) for v in bs]


@pytest.mark.parametrize(
    "h0,units,b,d",
    [
        (6, (4,), 64, 4),
        (6, (8, 6), 16, 16),
        (5, (6, 4), 128, 1),       # D < 4: one lane holds several batch rows
        (5, (6, 4), 64, 2),
        (7, (10, 8, 6), 8, 128),   # D = 128: one warp pools one batch row
        (26, (100, 100), 512, 16),
        (39, (256, 128), 128, 8),
        (128, (256, 512), 16, 8),  # the widest fields and maps: a final pass of 256 maps
        (26, (100, 100), 4, 256),  # D 256: two tiles a batch row
    ],
)
@pytest.mark.parametrize("act", ACTS)
def test_k1_matches_plain_version(cuda, h0, units, b, d, act):
    x0c, ws, bs = _inputs(h0, units, b, d, 11, cuda)
    before = cin_chain.LAUNCHES
    got = cin_chain.cin_chain_fm(x0c, ws, bs, units, d, act)
    torch.cuda.synchronize()
    assert cin_chain.LAUNCHES == before + 1
    ref = cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert (r - g).abs().max().item() <= 1e-3 * r.abs().max().item()


def test_k1_raises_on_geometry_it_does_not_take(cuda):
    x0c, ws, bs = _inputs(5, (6, 4), 10, 10, 0, cuda)  # D = 10 is not a power of two
    with pytest.raises(ValueError, match="power of two"):
        cin_chain.cin_chain_fm(x0c, ws, bs, (6, 4), 10, "relu")


def test_cin_outside_the_chain_takes_k4_on_cuda(cuda):
    from recman_tpu_torch.layers import CIN

    cin = CIN(field_size=5, cross_layer_units=(6, 4), activation="relu",
              dropout_keep=(1, 1, 1))
    params = cin.init(torch.Generator().manual_seed(0), device=cuda)
    x = torch.randn((8, 5, 10), device=cuda)  # D = 10: not a chain geometry
    before = (cin_chain.LAUNCHES, cin_interact.LAUNCHES)
    got = cin.apply(params, x)
    torch.cuda.synchronize()
    assert (cin_chain.LAUNCHES - before[0], cin_interact.LAUNCHES - before[1]) == (0, 2)
    ref = cin.apply({k: v.cpu() for k, v in params.items()}, x.cpu())
    _close(ref, got.cpu(), 1e-4)


def test_serving_on_card_matches_cpu(cuda):
    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.serving import Predictor

    hp = {"embedding_size": 16, "cin_cross_layer_units": (8, 6),
          "cin_dropout": (1, 1, 1), "deep_hidden_units": (32, 32)}
    model = XDeepFM(create_criteo_features(num_buckets=1000), hp)
    params = model.init_params(torch.Generator().manual_seed(0))
    data = synthetic_criteo_arrays(300, num_buckets=1000, seed=5)
    before = cin_chain.LAUNCHES
    got = Predictor(model, params, batch_size=128).predict(data)
    assert cin_chain.LAUNCHES == before + 3
    ref = Predictor(model, params, batch_size=128, device="cpu").predict(data)
    assert np.abs(got - ref).max() <= 1e-5


def _export_served(tmp_path, hp, platforms=None, device=None):
    """A small Criteo xDeepFM's Predictor at batch 128, its artifact loaded
    on the card, and 300 encoded rows."""
    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.serving import ExportedPredictor, Predictor

    model = XDeepFM(create_criteo_features(num_buckets=1000), hp)
    params = model.init_params(torch.Generator().manual_seed(0), device=device)
    data = synthetic_criteo_arrays(300, num_buckets=1000, seed=5)
    data.pop("y")
    pred = Predictor(model, params, batch_size=128, device=device)
    d = pred.export(str(tmp_path), data, platforms=platforms)
    return pred, ExportedPredictor.load(d), data, d


@pytest.mark.parametrize("k, op, per_batch", [(16, "cin_chain_fwd", 1), (10, "cin_interact_fwd", 2)])
def test_cuda_export_keeps_the_kernel_op(cuda, tmp_path, k, op, per_batch):
    """A CUDA export keeps K1 (the chain, k 16) or K4 (per-layer, k 10) as
    one node of its registered op; the artifact launches it as the live
    predictor does and serves its predictions within 1e-6."""
    hp = {"embedding_size": k, "cin_cross_layer_units": (8, 6), "cin_dropout": (1, 1, 1),
          "deep_hidden_units": (32, 32)}
    from recman_tpu_torch.serving import op_nodes

    pred, served, data, d = _export_served(tmp_path, hp)
    assert op_nodes(d) == {f"recman_tpu_torch.{op}.default"}
    counter = cin_chain if op == "cin_chain_fwd" else cin_interact
    before = counter.LAUNCHES
    got = served.predict(data)
    torch.cuda.synchronize()
    assert counter.LAUNCHES == before + 3 * per_batch  # 300 rows: 3 batches of 128
    assert np.abs(got - pred.predict(data)).max() <= 1e-6


def test_portable_export_from_the_cpu_serves_on_the_card(cuda, tmp_path):
    """A ("cpu", "cuda") export traced on the CPU holds a plain program for
    the CPU and one with K1's op node for the card. Loaded on the card, the
    card's program is moved there and launches K1 once a batch, never a
    plain twin, and serves a live card predictor's predictions within 1e-6
    (the same kernels); loaded on the CPU, the plain one serves the CPU
    predictor's within 1e-6. A ("cpu",) artifact does not load on the
    card."""
    from recman_tpu_torch.serving import ExportedPredictor, Predictor, op_nodes

    hp = {"embedding_size": 16, "cin_cross_layer_units": (8, 6), "cin_dropout": (1, 1, 1),
          "deep_hidden_units": (32, 32)}
    pred, served, data, d = _export_served(tmp_path / "both", hp, ("cpu", "cuda"), "cpu")
    assert op_nodes(d, "cpu") == set()
    assert op_nodes(d, "cuda") == {"recman_tpu_torch.cin_chain_fwd.default"}
    assert served.device.type == "cuda" and all(v.is_cuda for v in served.params.values())
    live = Predictor(pred.model, pred.params, batch_size=128, device="cuda")
    before = cin_chain.LAUNCHES
    got = served.predict(data)
    torch.cuda.synchronize()
    assert cin_chain.LAUNCHES == before + 3  # 300 rows: 3 batches of 128
    assert np.abs(got - live.predict(data)).max() <= 1e-6
    on_cpu = ExportedPredictor.load(d, device="cpu").predict(data)
    assert np.abs(on_cpu - pred.predict(data)).max() <= 1e-6
    cpu_only = pred.export(str(tmp_path / "cpu"), data, platforms=("cpu",))
    with pytest.raises(ValueError, match="serves on"):
        ExportedPredictor.load(cpu_only)


# (H0, units, B*D): K1's limit end to end, of max|ref|, where 1e-3 does
# not hold between two f32 sum orders (see the top). At the bench chain
# the twin itself reads up to 1.281e-3 (B 8192) and 1.095e-3 (B 65,536)
# from the exact chain, K1 up to 8.57e-4 and 1.088e-3, and the two 1.281e-3
# and 1.095e-3 from each other, over the inputs of these tests and of
# chip_smoke.py (recman_tpu_torch/tools/chain_readings.py, NVIDIA H100 80GB
# HBM3, 700 W)
K1_E2E_TOL = {(26, (100, 100), 8192 * 16): 1.5e-3, (26, (100, 100), 65_536 * 16): 1.5e-3}


def _k1_twin(x0c, ws, bs, units, d, act, got):
    """K1's save-form outputs ``got`` (pooled blocks, then fmaps) held to
    the plain version end to end; returns the plain version run on K1's own
    feed rows, layer by layer, to hold K1 to at 1e-3."""
    n = len(units)
    tol = K1_E2E_TOL.get((x0c.shape[0], tuple(units), x0c.shape[1]), 1e-3)
    for r, g in zip(cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act, save=True), got):
        _close(r, g, tol)
    return cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act, save=True,
                                            feeds=got[n:])


def _close(ref, got, tol):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (ref - got).abs().max().item() <= tol * ref.abs().max().item()


CHAIN_CASES = [
    (6, (4,), 64, 4),
    (6, (8, 6), 16, 16),
    (5, (6, 4), 128, 1),
    (7, (10, 8, 6), 8, 128),
    (39, (256, 128), 128, 8),
    (128, (128, 64), 128, 8),    # the widest fields K1 takes
    (6, (100, 100, 100), 128, 8),  # the ML-100K anchor's chain: 8 blocks
    (26, (100, 100), 512, 16),
    (26, (100, 100), 8192, 16),  # the training geometry
    # the edges of the reference chain's range
    (26, (256, 256, 256), 64, 16),  # every fan-in 128 (xdeepfm_wide_cin_criteo)
    (26, (100, 257), 64, 16),       # a final layer of 257 maps: two passes
    (128, (256, 256), 16, 8),
    (128, (256, 512), 16, 8),       # a final layer of 512 maps, the widest fields
    (26, (100, 100), 4, 256),       # D 256: two 128-column tiles a batch row
    (6, (8, 6), 2, 1024),           # D 1024
    (6, (16,) * 8 + (10,), 32, 4),  # nine layers
]


@pytest.mark.parametrize("h0,units,b,d", CHAIN_CASES)
@pytest.mark.parametrize("act", ACTS)
def test_k1_save_and_k2_match_plain_versions(cuda, h0, units, b, d, act):
    x0c, ws, bs = _inputs(h0, units, b, d, 13, cuda)
    n = len(units)
    before = cin_chain.LAUNCHES
    got = cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act, save=True)
    torch.cuda.synchronize()
    assert cin_chain.LAUNCHES == before + 1 and len(got) == 2 * n
    ref = _k1_twin(x0c, ws, bs, units, d, act, got)
    for r, g in zip(ref, got):
        _close(r, g, 1e-3)
    gen = torch.Generator().manual_seed(5)
    gs = [torch.randn(p.shape, generator=gen).to(cuda) for p in ref[:n]]
    before = cin_chain.BWD_LAUNCHES
    dx0, dws, dbs = cin_chain.cin_chain_bwd(x0c, ws, bs, gs, got[n:], units, d, act)
    torch.cuda.synchronize()
    assert cin_chain.BWD_LAUNCHES == before + 1
    rdx0, rdws, rdbs = cin_chain.cin_chain_bwd_reference(x0c, ws, bs, gs, got[n:], units, d, act)
    _close(rdx0, dx0, 1e-3)
    for r, g in zip(rdws + rdbs, dws + dbs):
        _close(r, g, 1e-3)


@pytest.mark.parametrize("h0,units,b,d", CHAIN_CASES)
@pytest.mark.parametrize("act", ACTS)
def test_k2_final_dw_stays_near_the_exact_sums(cuda, h0, units, b, d, act):
    """K2's dW of the final layer, a sum over every column, in both forms,
    against the exact sums of the same bf16 terms (f64) on the fmaps each
    side reads, beside the plain twin's: within twice the twin's gap, or
    under 1e-7 of max|exact| (``chain_readings.near_exact``). The lower
    layers' gaps are led by bf16 roundings of gpre and of the feeds
    (``chain_readings dw_accuracy`` reads them layer by layer)."""
    from recman_tpu_torch.tools import chain_readings

    row = chain_readings.K2Case(h0, units, b, d, act, cuda).row()
    missed = {form: (row[f"{form}_kernel_exact"][-1], row[f"{form}_twin_exact"][-1])
              for form in ("k2_dw", "k2_recompute_dw") if not row[f"{form}_final_near_exact"]}
    assert not missed, missed


# the small odd geometry (Hk 5 and 3 pad to 8), the ML-100K anchor's, the
# widest maps and the widest fields K1 takes, the bench geometry
BIT_EQUAL_CASES = [(5, (6, 4), 64, 4), (6, (100, 100, 100), 128, 8), (39, (256, 128), 128, 8),
                   (128, (128, 64), 128, 8), (26, (100, 100), 8192, 16),
                   (128, (256, 512), 16, 8), (26, (100, 100), 4, 256),
                   (6, (16,) * 8 + (10,), 32, 4)]


@pytest.mark.parametrize("h0,units,b,d", BIT_EQUAL_CASES)
def test_k1_and_k2_are_bit_equal_on_two_calls(cuda, h0, units, b, d):
    """Each sum of K1 and K2 has one owner and a fixed order: two calls of
    K1 (with and without fmaps), of K2 and of K2's recompute form give the
    same bits, the pooled blocks of both K1 forms agree, and the recompute
    form equals the save form."""
    x0c, ws, bs = _inputs(h0, units, b, d, 19, cuda)
    n = len(units)
    act = "leaky_relu"
    fwd = [cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act) for _ in range(2)]
    save = [cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act, save=True) for _ in range(2)]
    gen = torch.Generator().manual_seed(9)
    gs = [torch.randn(p.shape, generator=gen).to(cuda) for p in fwd[0]]
    bwd = [cin_chain.cin_chain_bwd(x0c, ws, bs, gs, save[0][n:], units, d, act) for _ in range(2)]
    rec = [cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, act) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(fwd[0], fwd[1]))
    assert all(torch.equal(x, y) for x, y in zip(save[0], save[1]))
    assert all(torch.equal(x, y) for x, y in zip(fwd[0], save[0][:n]))
    flat = [[r[0], *r[1], *r[2]] for r in bwd + rec]
    for other in flat[1:]:
        assert all(torch.equal(x, y) for x, y in zip(flat[0], other))


def test_k2_plan_at_the_bench_geometry(cuda):
    # dx0 (26 x 128) and the two halves' dx0 partials (4 x 128) in f32,
    # bf16(gpre) (112 x 136) in bf16, then the larger of layer 1's W ring (3
    # stages of 56 rows x 136 maps, bf16) and the dxk it hands down (50 x
    # 128 f32)
    smem, splits = cin_chain.k2_plan(26, (100, 100), 8192 * 16, cuda)
    assert smem == (26 + 4) * 128 * 4 + 112 * 136 * 2 + max(3 * 56 * 136 * 2, 50 * 128 * 4)
    assert len(splits) == 2 and all(s >= 1 for s in splits)


def test_k2_plan_takes_the_widest_k1_geometry(cuda):
    assert cin_chain.k2_plan(39, (256, 128), 1024, cuda)[0] <= 232_448
    assert cin_chain.k2_plan(128, (128, 64), 1024, cuda)[0] <= 232_448


def test_chain_plans_fit_anywhere_in_the_range(cuda):
    """K1's and K2's plans (the kernel sources' own) stay within a block's
    232,448 bytes of shared memory at the corners of the range: H0 1, 26
    and 128, O 2, 256 and 512 (a non-final O at most 256), 1 to 3
    layers."""
    import itertools

    worst = 0
    for h0, depth in itertools.product((1, 26, 128), (1, 2, 3)):
        for units in itertools.product((2, 256, 512), repeat=depth):
            if cin_chain.chain_unsupported_reason(h0, units, 8, 1024) is not None:
                continue
            k1, k2 = cin_chain.k1_smem(h0, units), cin_chain.k2_plan(h0, units, 1024, cuda)[0]
            assert k1 <= 232_448 and k2 <= 232_448, (h0, units, k1, k2)
            worst = max(worst, k1, k2)
    assert worst > 0


def test_k2_is_deterministic(cuda):
    units = (100, 100)
    x0c, ws, bs = _inputs(26, units, 1024, 16, 3, cuda)
    out = cin_chain.cin_chain_fwd(x0c, ws, bs, units, 16, "leaky_relu", save=True)
    gs = [torch.randn_like(p) for p in out[:2]]
    a = cin_chain.cin_chain_bwd(x0c, ws, bs, gs, out[2:], units, 16, "leaky_relu")
    b = cin_chain.cin_chain_bwd(x0c, ws, bs, gs, out[2:], units, 16, "leaky_relu")
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1] + a[2], b[1] + b[2]))


@pytest.mark.parametrize("h0,units,b,d", CHAIN_CASES + [(26, (100, 100), 65_536, 16)])
@pytest.mark.parametrize("act", ACTS)
def test_k2_recompute_is_bit_equal_to_the_save_form(cuda, h0, units, b, d, act):
    if b == 65_536 and act != "leaky_relu":
        pytest.skip("the large-batch geometry runs its model's activation only")
    x0c, ws, bs = _inputs(h0, units, b, d, 17, cuda)
    n = len(units)
    out = cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act, save=True)
    gen = torch.Generator().manual_seed(6)
    gs = [torch.randn(p.shape, generator=gen).to(cuda) for p in out[:n]]
    saved = cin_chain.cin_chain_bwd(x0c, ws, bs, gs, out[n:], units, d, act)
    before = (cin_chain.RECOMPUTE_LAUNCHES, cin_chain.LAUNCHES, cin_chain.BWD_LAUNCHES)
    got = cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, act)
    torch.cuda.synchronize()
    assert (cin_chain.RECOMPUTE_LAUNCHES, cin_chain.LAUNCHES, cin_chain.BWD_LAUNCHES) == (
        before[0] + 1, before[1], before[2])
    assert torch.equal(saved[0], got[0])
    assert all(torch.equal(x, y) for x, y in zip(saved[1] + saved[2], got[1] + got[2]))
    # K1's fmaps (the bits the recompute form rebuilds) are held to K1's
    # twin end to end and on K1's own input, their sign differences few and
    # next to 0; the backward is held to K2's twin on those fmaps, the ones
    # it reads (the twin's own fmaps can round a feed element to the
    # neighbouring bf16 value, and a sign differing at a pre-activation next
    # to 0 moves that column's gpre by 0.8 of a term)
    twin = _k1_twin(x0c, ws, bs, units, d, act, out)[n:]
    _sign_flips(twin, out[n:])
    ref = cin_chain.cin_chain_bwd_reference(x0c, ws, bs, gs, out[n:], units, d, act)
    _close(ref[0], got[0], 1e-3)
    for r, g in zip(ref[1] + ref[2], got[1] + got[2]):
        _close(r, g, 1e-3)


def _sign_flips(twin, fmaps):
    """K1's fmaps within 1e-3 of the twin's; the elements of other sign at
    most 1e-5 of them (or one), each where the twin is within 1e-5 of its
    max|ref| of 0. Returns their count."""
    flips = numel = 0
    for t, f in zip(twin, fmaps):
        _close(t, f, 1e-3)
        flip = (t > 0) != (f > 0)
        if flip.any():
            assert t[flip].abs().max().item() <= 1e-5 * t.abs().max().item()
        flips, numel = flips + int(flip.sum()), numel + t.numel()
    assert flips <= max(1, 1e-5 * numel)
    return flips


def test_chain_recompute_form_on_card(cuda, monkeypatch):
    """cin_chain_fm under CHAIN_SAVE_FMAPS = False: K1 without fmaps and
    K2's recompute form, whose gradients are the save form's bits."""
    units = (100, 100)
    x0c, ws, bs = _inputs(26, units, 1024, 16, 4, cuda)
    grads, counts = [], []
    for save in (True, False):
        monkeypatch.setattr(cin_chain, "CHAIN_SAVE_FMAPS", save)
        leaves = [t.clone().requires_grad_() for t in (x0c, *ws, *bs)]
        before = (cin_chain.LAUNCHES, cin_chain.SAVE_LAUNCHES, cin_chain.BWD_LAUNCHES,
                  cin_chain.RECOMPUTE_LAUNCHES)
        out = cin_chain.cin_chain_fm(leaves[0], leaves[1:3], leaves[3:], units, 16)
        sum((o.square() * (i + 1)).sum() for i, o in enumerate(out)).backward()
        torch.cuda.synchronize()
        counts.append(tuple(a - b for a, b in zip(
            (cin_chain.LAUNCHES, cin_chain.SAVE_LAUNCHES, cin_chain.BWD_LAUNCHES,
             cin_chain.RECOMPUTE_LAUNCHES), before)))
        grads.append([t.grad for t in leaves])
    assert counts == [(1, 1, 1, 0), (1, 0, 0, 1)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def _sorted_case(t, c, n, v, seed, device, kind="zipf"):
    """Sorted Zipf(1.2) ids, as the synthetic Criteo rows have them, and
    random cotangents. ``kind`` shapes the ids where K3's and K7's
    position chunks meet runs: "one id" makes row 0 one run across every
    chunk; "outside" starts each row with ids below 0 and ends it with ids
    past V; "aligned" makes runs of 64 positions, so that every chunk
    boundary is also a run boundary."""
    rs = np.random.RandomState(seed)
    ids = np.minimum(rs.zipf(1.2, size=(t, n)) + 1, v - 1).astype(np.int32)
    if kind == "one id":
        ids[0] = v // 2
    elif kind == "outside":
        ids[:, : n // 5] = -1 - rs.randint(0, 3, size=(t, n // 5))
        ids[:, n - n // 7:] = v + rs.randint(0, 3, size=(t, n // 7))
    elif kind == "aligned":
        ids = np.tile(np.arange(n, dtype=np.int32) // 64 * 3 % v, (t, 1))
    sids = torch.from_numpy(np.sort(ids, axis=1)).to(device)
    sg = torch.from_numpy(rs.randn(t, c, n).astype(np.float32)).to(device)
    return sids, sg


@pytest.mark.parametrize("kind,t,c,n,v", [
    ("zipf", 3, 5, 70, 50), ("zipf", 4, 17, 512, 1001), ("zipf", 2, 3, 5000, 7),
    ("zipf", 26, 17, 8192, 100_001),
    ("zipf", 26, 17, 65_536, 100_001),  # the large-batch step's geometry
    ("one id", 3, 17, 8192, 100_001), ("outside", 4, 5, 3001, 1001),
    ("aligned", 2, 17, 4096, 100_001),
    ("one id", 1, 3, 140_000, 100_001),  # the fix-up carries its scan across three tiles
])
def test_k3_matches_plain_version(cuda, kind, t, c, n, v):
    sids, sg = _sorted_case(t, c, n, v, t + n, cuda, kind)
    before = segment_matmul.LAUNCHES
    got = segment_matmul.segment_matmul_from_sorted_batched(sids, sg, v)
    again = segment_matmul.segment_matmul_from_sorted_batched(sids, sg, v)
    torch.cuda.synchronize()
    assert segment_matmul.LAUNCHES == before + 2
    ref = segment_matmul.segment_matmul_reference(sids, sg, v)
    _close(ref, got, 1e-5)
    assert torch.equal(got == 0, ref == 0)
    assert torch.equal(got, again)


@pytest.mark.parametrize("kind,t,k_emb,n_vec,n,v", [
    ("zipf", 3, 4, 1, 70, 50), ("zipf", 4, 16, 2, 512, 1001), ("zipf", 2, 3, 0, 5000, 7),
    ("zipf", 1, 95, 1, 300, 700), ("zipf", 1, 96, 1, 300, 700),
    ("zipf", 26, 16, 1, 8192, 100_001),
    ("zipf", 26, 16, 1, 32_768, 100_001),  # the reference's SEGMAT_SEGMENT_N
    ("one id", 3, 16, 1, 8192, 100_001), ("outside", 4, 4, 1, 3001, 1001),
    ("aligned", 2, 16, 1, 4096, 100_001),
    ("one id", 1, 2, 1, 140_000, 100_001),  # the fix-up carries its scan across three tiles
])
def test_k7_matches_plain_version_and_k3(cuda, kind, t, k_emb, n_vec, n, v):
    sids, sg = _sorted_case(t, k_emb + n_vec, n, v, t + n + 1, cuda, kind)
    before = segment_matmul.VK_LAUNCHES
    emb, vec = segment_matmul.segment_matmul_from_sorted_batched_vk(sids, sg, v, k_emb, n_vec)
    again = segment_matmul.segment_matmul_from_sorted_batched_vk(sids, sg, v, k_emb, n_vec)
    torch.cuda.synchronize()
    assert segment_matmul.VK_LAUNCHES == before + 2
    assert emb.shape == (t, v, k_emb) and vec.shape == (t, n_vec, v)
    ref_emb, ref_vec = segment_matmul.segment_matmul_vk_reference(sids, sg, v, k_emb, n_vec)
    for r, g in ((ref_emb, emb), (ref_vec, vec)):
        if r.numel():
            _close(r, g, 1e-5)
        assert torch.equal(g == 0, r == 0)
    assert torch.equal(emb, again[0]) and torch.equal(vec, again[1])
    k3 = segment_matmul.segment_matmul_from_sorted_batched(sids, sg, v)
    assert torch.equal(k3[:, :k_emb].transpose(1, 2), emb) and torch.equal(k3[:, k_emb:], vec)


def test_k3_wrapper_raises_on_what_it_does_not_take(cuda):
    sids, sg = _sorted_case(2, 17, 64, 100, 0, cuda)
    with pytest.raises(ValueError, match="int32"):
        segment_matmul.segment_matmul_from_sorted_batched(sids.long(), sg, 100)
    with pytest.raises(ValueError, match="do not match"):
        segment_matmul.segment_matmul_from_sorted_batched(sids[:1], sg, 100)
    # one write-pass line a (table, row): 65,536 lines are one too many
    sids, sg = _sorted_case(1, 65_536, 1, 100, 0, cuda)
    with pytest.raises(ValueError, match=r"T \* C <= 65535"):
        segment_matmul.segment_matmul_from_sorted_batched(sids, sg, 100)


def test_k7_wrapper_raises_on_what_it_does_not_take(cuda):
    sids, sg = _sorted_case(2, 17, 64, 100, 0, cuda)
    with pytest.raises(ValueError, match="k_emb"):
        segment_matmul.segment_matmul_from_sorted_batched_vk(sids, sg, 100, 16, 2)
    with pytest.raises(ValueError, match="int32"):
        segment_matmul.segment_matmul_from_sorted_batched_vk(sids.long(), sg, 100, 16, 1)
    # a table's grad is one line of the write pass, with int offsets
    with pytest.raises(ValueError, match=r"V \* k_emb <= 2\*\*30"):
        segment_matmul.segment_matmul_from_sorted_batched_vk(sids, sg, 2**26 + 1, 16, 1)
    sids, sg = _sorted_case(1, 16 + 65_536, 1, 100, 0, cuda)
    with pytest.raises(ValueError, match=r"T \* max\(n_vec, 1\) <= 65535"):
        segment_matmul.segment_matmul_from_sorted_batched_vk(sids, sg, 100, 16, 65_536)


def test_cin_with_live_dropout_takes_k4_and_k5_on_cuda_in_training(cuda):
    from recman_tpu_torch.layers import CIN

    cin = CIN(field_size=5, cross_layer_units=(6, 4), activation="relu",
              dropout_keep=(1, 0.5, 1))
    params = cin.init(torch.Generator().manual_seed(0), device=cuda)
    x = torch.randn((32, 5, 4), device=cuda)
    before = cin_chain.LAUNCHES
    assert cin.apply(params, x).shape == (32, 1)  # eval: the chain
    assert cin_chain.LAUNCHES == before + 1
    p = {k: v.requires_grad_() for k, v in params.items()}
    counts = (cin_chain.LAUNCHES, cin_interact.LAUNCHES, cin_interact.BWD_LAUNCHES)
    out = cin.apply(p, x, training=True, generator=torch.Generator(device=cuda).manual_seed(1))
    out.sum().backward()
    torch.cuda.synchronize()
    after = (cin_chain.LAUNCHES, cin_interact.LAUNCHES, cin_interact.BWD_LAUNCHES)
    assert [a - c for a, c in zip(after, counts)] == [0, 2, 2]
    assert all(torch.isfinite(v.grad).all() for v in p.values())


def test_dnn_dropout_draws_its_mask_on_the_card(cuda):
    from recman_tpu_torch.layers import DNN

    dnn = DNN(32, (64, 64), (0.5, 0.8, 0.8), "relu")
    params = dnn.init(torch.Generator().manual_seed(0), device=cuda)
    x = torch.randn((256, 32), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = dnn.apply(params, x, training=True, generator=gen)
    b = dnn.apply(params, x, training=True, generator=gen)
    assert a.is_cuda and torch.isfinite(a).all() and not torch.equal(a, b)
    assert torch.equal(dnn.apply(params, x, training=True, generator=torch.Generator(
        device=cuda).manual_seed(1)), a)
    with pytest.raises(ValueError, match="generator"):
        dnn.apply(params, x, training=True, generator=torch.Generator().manual_seed(1))


def test_stacked_train_step_on_card_matches_cpu(cuda):
    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.serving import batch_indices
    from recman_tpu_torch.training import (
        create_optimizer, gather_batch, pack_dataset, stack_table_params, unpack_batch,
    )
    from recman_tpu_torch.training.train_step import loss_and_grads

    hp = {"embedding_size": 16, "cin_cross_layer_units": (8, 6),
          "cin_dropout": (1, 1, 1), "deep_hidden_units": (32, 32),
          "deep_dropout": (1.0, 1.0, 1.0)}
    model = XDeepFM(create_criteo_features(num_buckets=1000), hp)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    params_s, names = stack_table_params(model, params)
    data, layout = pack_dataset(synthetic_criteo_arrays(512, num_buckets=1000, seed=2019))
    idx = torch.as_tensor(batch_indices(512, 256, shuffle_seed=0)[0])
    results = {}
    for dev in ("cpu", cuda):
        tdata = {k: torch.as_tensor(v).to(dev) for k, v in data.items()}
        batch, w = gather_batch(tdata, idx.to(dev))
        p = {k: v.to(dev) for k, v in params_s.items()}
        counts = (cin_chain.LAUNCHES, cin_chain.BWD_LAUNCHES, segment_matmul.LAUNCHES)
        results[str(dev)] = loss_and_grads(model, p, unpack_batch(batch, layout), w, names=names)
        after = (cin_chain.LAUNCHES, cin_chain.BWD_LAUNCHES, segment_matmul.LAUNCHES)
        assert [a - c for a, c in zip(after, counts)] == ([0, 0, 0] if dev == "cpu" else [1, 1, 1])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results[str(cuda)]
    assert abs(l_gpu.item() - l_cpu.item()) <= 1e-5 * abs(l_cpu.item())
    for k in g_cpu:
        _close(g_cpu[k], g_gpu[k].cpu(), 1e-3)
    opt = create_optimizer("adam", 1e-3)
    assert opt.update(g_gpu, opt.init(g_gpu))[1].count.item() == 1



def test_one_rank_nccl_dp_step_matches_the_plain_step(cuda):
    """parallel/: the explicit DP step on a one-rank NCCL group (make_mesh
    with no group) against the plain step on the same card: the same loss
    and params (1e-6), K1 save, K2 and K3 once each."""
    import torch.distributed as dist

    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.parallel import make_mesh
    from recman_tpu_torch.parallel.train_explicit import make_dp_train_step_explicit
    from recman_tpu_torch.serving import batch_indices
    from recman_tpu_torch.training import create_optimizer, init_state, make_train_step, pack_dataset

    hp = {"embedding_size": 16, "cin_cross_layer_units": (8, 6),
          "cin_dropout": (1, 1, 1), "deep_hidden_units": (32, 32),
          "deep_dropout": (1.0, 1.0, 1.0)}
    model = XDeepFM(create_criteo_features(num_buckets=1000), hp)
    data, layout = pack_dataset(synthetic_criteo_arrays(512, num_buckets=1000, seed=2019))
    data = {k: torch.as_tensor(v).to(cuda) for k, v in data.items()}
    idx = torch.as_tensor(batch_indices(512, 256, shuffle_seed=0)[0]).to(cuda)
    opt = create_optimizer("adam", 1e-3)
    mesh = make_mesh(device=cuda)
    try:
        assert dist.get_backend() == "nccl" and mesh.shape == {"data": 1, "model": 1}
        ref, ref_loss = make_train_step(model, opt)(
            init_state(model, opt, torch.Generator().manual_seed(0), device=cuda), data, idx, layout)
        before = (cin_chain.SAVE_LAUNCHES, cin_chain.BWD_LAUNCHES, segment_matmul.LAUNCHES)
        got, losses = make_dp_train_step_explicit(model, opt, mesh)(
            init_state(model, opt, torch.Generator().manual_seed(0), device=cuda), data, idx[None],
            layout)
        after = (cin_chain.SAVE_LAUNCHES, cin_chain.BWD_LAUNCHES, segment_matmul.LAUNCHES)
        assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
        assert abs(losses[0].item() - ref_loss.item()) <= 1e-6 * abs(ref_loss.item())
        for k, v in ref.params.items():
            torch.testing.assert_close(got.params[k], v, rtol=1e-6, atol=1e-9)
    finally:
        dist.destroy_process_group()

def _rows_case(n, v, c, seed, device, hot=None):
    """Sorted Zipf(1.2) ids and random (N, C) cotangents. A float ``hot``
    gives id 0 that share of the rows, as PAD (clamped to 0) in genres (1.0:
    one run over every chunk); "outside" starts the ids below 0 (PAD -1)
    and ends them past V; "aligned" makes runs of 64 positions, so that
    every 128-position chunk of K6's sums ends where a run ends."""
    rs = np.random.RandomState(seed)
    ids = np.minimum(rs.zipf(1.2, n) - 1, v - 1)
    if hot == "outside":
        ids[: n // 5] = -1 - rs.randint(0, 3, n // 5)
        ids[n - n // 7:] = v + rs.randint(0, 3, n // 7)
    elif hot == "aligned":
        ids = np.arange(n) // 64 * 3 % v
    elif hot is not None:
        ids = np.where(rs.rand(n) < hot, 0, ids)
    sids = torch.from_numpy(np.sort(ids).astype(np.int32)).to(device)
    sg = torch.from_numpy(rs.randn(n, c).astype(np.float32)).to(device)
    return sids, sg


K6_CASES = [
    (128, 944, 9, None),     # ML-100K user_id
    (128, 3, 9, None),       # gender
    (2432, 20, 9, 0.85),     # genres: the longest run
    (1280, 1574, 8, 0.085),  # ML-100K history, 128 x 10 into item_id's table, PAD at id 0
    (77, 30, 3, None),       # N not a multiple of 8
    (5000, 7, 256, 0.5),     # the first port's widest C
    (8192, 100_001, 17, None),  # one Criteo table
    (140_000, 100_001, 3, 1.0),  # one id: the fix-up carries its scan across three tiles
    (3001, 1001, 9, "outside"),  # ids below 0 and past V
    (3000, 50, 300, 0.3),    # C past the first port's 256
    (4096, 100_001, 17, "aligned"),  # runs end on chunk boundaries
    (8192, 1_000_001, 17, None),  # an output past the L2 cache (68 MB)
    (140_000, 1_500_000, 3, 1.0),  # one id over 1,094 chunks, a grid-stride sums phase
    (8192, 316, 16, None),   # a QR quotient table at the bench widths (q 317)
    (8192, 317, 16, None),   # its remainder table
]


@pytest.mark.parametrize("n,v,c,hot", K6_CASES)
def test_k6_matches_plain_version_and_is_deterministic(cuda, n, v, c, hot):
    sids, sg = _rows_case(n, v, c, n + v, cuda, hot)
    before = segment_matmul.ROWS_LAUNCHES
    got = segment_matmul.segment_matmul_from_sorted(sids, sg, v)
    again = segment_matmul.segment_matmul_from_sorted(sids, sg, v)
    torch.cuda.synchronize()
    assert segment_matmul.ROWS_LAUNCHES == before + 2
    ref = segment_matmul.segment_matmul_rows_reference(sids, sg, v)
    _close(ref, got, 1e-5)
    assert torch.equal(got == 0, ref == 0) and got.is_contiguous()
    assert torch.equal(got, again)


@pytest.mark.parametrize("n,v,c,hot", [(2432, 20, 9, 0.85), (8192, 100_001, 17, None),
                                       (140_000, 100_001, 3, 1.0)])
def test_k6_is_k7_at_one_table(cuda, n, v, c, hot):
    """K6 runs K7's sums and fix-up at T = 1 with the cotangents read in
    place: the same sums in the same order, bit for bit."""
    sids, sg = _rows_case(n, v, c, n + v, cuda, hot)
    k6 = segment_matmul.segment_matmul_from_sorted(sids, sg, v)
    emb, _ = segment_matmul.segment_matmul_from_sorted_batched_vk(
        sids[None], sg.t().contiguous()[None], v, c, 0)
    torch.cuda.synchronize()
    assert torch.equal(k6, emb[0])


def test_k6_wrapper_raises_on_what_it_does_not_take(cuda):
    sids, sg = _rows_case(64, 10, 17, 0, cuda)
    with pytest.raises(ValueError, match="nonempty"):
        segment_matmul.segment_matmul_from_sorted(sids, sg, 0)
    with pytest.raises(ValueError, match="int32"):
        segment_matmul.segment_matmul_from_sorted(sids.long(), sg, 10)
    with pytest.raises(ValueError, match="do not match"):
        segment_matmul.segment_matmul_from_sorted(sids[:-1], sg, 10)


@pytest.mark.parametrize("kind,k6,scatter_calls", [("segmat", 1, 0), ("scatter", 0, 1),
                                                   ("auto", 0, 1)])
def test_lookup_backward_route_on_card(cuda, monkeypatch, kind, k6, scatter_calls):
    """A single lookup's backward on a CUDA tensor: "segmat" launches K6
    once and never reaches index_add_ or the twin; "scatter" and "auto"
    launch no K6."""
    from recman_tpu_torch.ops import embedding as emb

    calls = {"scatter": 0}
    real = emb._scatter_sorted_rows

    def counting(*a):
        calls["scatter"] += 1
        return real(*a)

    monkeypatch.setattr(emb, "_scatter_sorted_rows", counting)
    monkeypatch.setattr(segment_matmul, "segment_matmul_rows_reference", None)  # never reached
    table = torch.randn((944, 9), device=cuda, requires_grad=True)
    ids = torch.randint(0, 944, (128,), device=cuda)
    before = segment_matmul.ROWS_LAUNCHES
    with emb.grad_kernel(kind):
        emb.embedding_lookup(table, ids).square().sum().backward()
    torch.cuda.synchronize()
    assert segment_matmul.ROWS_LAUNCHES - before == k6 and calls["scatter"] == scatter_calls
    ref = torch.zeros_like(table).index_add_(0, ids, 2 * table.detach()[ids])
    _close(ref, table.grad, 1e-5)


def test_ml_train_step_on_card_launches_k6_per_field(cuda):
    """One ML-100K-shaped train step under "segmat": K6 once per embedded
    field, K1 (save) and K2 once, and the step's gradients against the
    same step on the CPU under the same contexts."""
    from recman_tpu_torch.data import concat_rows, create_ml_features, get_ml_dataset
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.ops import embedding as emb
    from recman_tpu_torch.training import gather_batch, pack_dataset, unpack_batch
    from recman_tpu_torch.training.train_step import loss_and_grads

    train, valid, _, domains = get_ml_dataset(frac=0.05)
    fs = create_ml_features(concat_rows(train, valid), domains)
    hp = {"deep_dropout": (1.0, 1.0, 1.0)}
    model = XDeepFM(fs, hp)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    data, layout = pack_dataset(fs.transform(train, y=train["label"]))
    idx = torch.arange(128)
    results = {}
    for dev in ("cpu", cuda):
        tdata = {k: torch.as_tensor(v).to(dev) for k, v in data.items()}
        batch, w = gather_batch(tdata, idx.to(dev))
        p = {k: v.to(dev) for k, v in params.items()}
        counts = (cin_chain.LAUNCHES, cin_chain.BWD_LAUNCHES, segment_matmul.ROWS_LAUNCHES)
        with emb.fused_grad(True), emb.grad_kernel("segmat"):
            results[str(dev)] = loss_and_grads(model, p, unpack_batch(batch, layout), w)
        after = (cin_chain.LAUNCHES, cin_chain.BWD_LAUNCHES, segment_matmul.ROWS_LAUNCHES)
        assert [a - c for a, c in zip(after, counts)] == ([0, 0, 0] if dev == "cpu" else [1, 1, 6])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results[str(cuda)]
    assert abs(l_gpu.item() - l_cpu.item()) <= 1e-5 * abs(l_cpu.item())
    for k in g_cpu:
        _close(g_cpu[k], g_gpu[k].cpu(), 1e-3)


@pytest.mark.parametrize("name", ["fm", "deepfm", "dcn", "fwfm", "wide_deep", "nfm", "afm",
                                  "din", "bst", "dien"])
def test_zoo_train_step_on_card_launches_k6_per_field(cuda, name):
    """One ML-100K train step of each FM-family model, DCN and the sequence
    family under "segmat", every keep 1: K6 once per embedded field (and
    once more for the sequence models' history, which looks up item_id's
    table a second time) and no other kernel, and the loss and every
    gradient against the same step on the CPU."""
    from recman_tpu_torch.data import (
        add_history_feature, concat_rows, create_ml_features, create_ml_sequence_features,
        get_ml_dataset,
    )
    from recman_tpu_torch.models import model_class
    from recman_tpu_torch.ops import embedding as emb
    from recman_tpu_torch.training import gather_batch, pack_dataset, unpack_batch
    from recman_tpu_torch.training.train_step import loss_and_grads

    train, valid, test, domains, index = get_ml_dataset(frac=0.05, return_index=True)
    sequence = model_class(name).requires_sequence
    if sequence:
        train, valid, _ = add_history_feature(train, valid, test, index=index)
        fs = create_ml_sequence_features(concat_rows(train, valid), domains)
    else:
        fs = create_ml_features(concat_rows(train, valid), domains)
    model = model_class(name)(fs, {"deep_dropout": (1.0, 1.0, 1.0)})
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    data, layout = pack_dataset(fs.transform(train, y=train["label"]))
    idx = torch.arange(128)
    results = {}
    for dev in ("cpu", cuda):
        tdata = {k: torch.as_tensor(v).to(dev) for k, v in data.items()}
        batch, w = gather_batch(tdata, idx.to(dev))
        p = {k: v.to(dev) for k, v in params.items()}
        counts = (cin_chain.LAUNCHES, segment_matmul.LAUNCHES, segment_matmul.ROWS_LAUNCHES)
        with emb.fused_grad(True), emb.grad_kernel("segmat"):
            results[str(dev)] = loss_and_grads(model, p, unpack_batch(batch, layout), w)
        after = (cin_chain.LAUNCHES, segment_matmul.LAUNCHES, segment_matmul.ROWS_LAUNCHES)
        k6 = 7 if sequence else 6
        assert [a - c for a, c in zip(after, counts)] == ([0, 0, 0] if dev == "cpu" else [0, 0, k6])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results[str(cuda)]
    assert abs(l_gpu.item() - l_cpu.item()) <= 1e-5 * abs(l_cpu.item())
    for k in g_cpu:
        _close(g_cpu[k], g_gpu[k].cpu(), 1e-3)


def _interact_inputs(h0, hk, o, bd, seed, device):
    g = torch.Generator().manual_seed(seed)
    x0c = torch.randn((h0, bd), generator=g)
    xkc = torch.randn((hk, bd), generator=g)
    w = torch.randn((h0 * hk, o), generator=g) * (2.0 / (h0 * hk + o)) ** 0.5
    cot = torch.randn((o, bd), generator=g)
    return [t.to(device) for t in (x0c, xkc, w, cot)]


INTERACT_CASES = [
    (5, 3, 8, 64),            # the CPU tests' small geometry
    (5, 40, 8, 8),            # 32 < Hk <= 64
    (7, 5, 9, 301),           # tail tile; B*D not a multiple of 4
    (26, 26, 200, 40_960),    # the paper's Criteo layer 0 (B 4096, D 10)
    (26, 100, 200, 40_960),   # its layers 1 and 2
    (26, 100, 300, 1000),     # two map tiles in K4
    (3, 128, 512, 130),       # the widest fan-in and maps
    (130, 1, 4, 200),         # H0 over 128, Hk 1
    (5, 13, 40, 999),         # Hk neither a multiple of 8 nor of 16
    (26, 100, 257, 40_960),   # the per-layer route's final layer of 257 maps
    (26, 100, 264, 4_096),    # O 264: two map tiles, and a second n8 tile run
    (26, 100, 200, 40),       # B*D under one column tile
]


@pytest.mark.parametrize("h0,hk,o,bd", INTERACT_CASES)
def test_k4_and_k5_match_plain_versions(cuda, h0, hk, o, bd):
    """K4 and K5 against their twins, 1e-3 of each output's largest
    element (the same bf16 roundings, f32 sums in another order); K4 and
    K5 bit-equal on two calls."""
    x0c, xkc, w, g = _interact_inputs(h0, hk, o, bd, h0 + hk + o, cuda)
    before = (cin_interact.LAUNCHES, cin_interact.BWD_LAUNCHES)
    got = cin_interact.cin_interact_fwd(x0c, xkc, w)
    got_again = cin_interact.cin_interact_fwd(x0c, xkc, w)
    grads = cin_interact.cin_interact_bwd(x0c, xkc, w, g)
    again = cin_interact.cin_interact_bwd(x0c, xkc, w, g)
    torch.cuda.synchronize()
    assert (cin_interact.LAUNCHES - before[0], cin_interact.BWD_LAUNCHES - before[1]) == (2, 2)
    _close(cin_interact.cin_interact_fm_reference(x0c, xkc, w), got, 1e-3)
    assert torch.equal(got, got_again)
    for r, a, b in zip(cin_interact.cin_interact_fm_bwd_reference(x0c, xkc, w, g), grads, again):
        _close(r, a, 1e-3)
        assert torch.equal(a, b)


_SUM_NAMES = ("k4_out", "k5_dx0", "k5_dxk", "k5_dw")


@pytest.mark.parametrize("h0,hk,o,bd", INTERACT_CASES)
def test_k4_and_k5_sums_stay_near_the_exact_sums(cuda, h0, hk, o, bd):
    """The tensor cores' f32 sums of K4 (its output) and K5 (dx0, dxk, dW)
    against the exact sums of the same bf16 terms (f64), beside the plain
    twin's: within twice the twin's gap, or under 1e-7 of max|exact|
    (``chain_readings.near_exact``)."""
    from recman_tpu_torch.tools import chain_readings

    row = chain_readings.InteractCase(h0, hk, o, bd, cuda).row()
    missed = {name: (row[f"{name}_kernel_exact"], row[f"{name}_twin_exact"])
              for name in _SUM_NAMES if not row[f"{name}_near_exact"]}
    assert not missed, missed


def test_cin_interact_fm_shared_input_on_card(cuda):
    """Layer 0 passes x0c as xkc: autograd sums K5's dx0 and dxk."""
    x0c, _, w, g = _interact_inputs(6, 6, 10, 640, 1, cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        x = x0c.detach().to(dev).requires_grad_()
        cin_interact.cin_interact_fm(x, x, w.to(dev)).backward(g.to(dev))
        grads.append(x.grad.cpu())
    _close(grads[1], grads[0], 1e-3)


def test_k4_and_k5_wrappers_raise_on_what_they_do_not_take(cuda):
    x0c, xkc, w, g = _interact_inputs(3, 129, 8, 64, 0, cuda)
    with pytest.raises(ValueError, match="Hk <= 128"):
        cin_interact.cin_interact_fwd(x0c, xkc, w)
    x0c, xkc, w, g = _interact_inputs(3, 4, 513, 64, 0, cuda)
    with pytest.raises(ValueError, match="O <= 512"):
        cin_interact.cin_interact_bwd(x0c, xkc, w, g)
    x0c, xkc, w, g = _interact_inputs(3, 4, 8, 64, 0, cuda)
    with pytest.raises(ValueError, match="cotangent"):
        cin_interact.cin_interact_bwd(x0c, xkc, w, g[:, :32].contiguous())


def test_cin_remat_on_card_launches_k4_twice_a_layer(cuda):
    from recman_tpu_torch.layers import CIN

    x = torch.randn((64, 5, 10), device=cuda)
    grads = []
    for remat in (False, True):
        cin = CIN(field_size=5, cross_layer_units=(6, 4), activation="relu",
                  dropout_keep=(1, 0.5, 0.5), remat=remat)
        p = {k: v.requires_grad_() for k, v in
             cin.init(torch.Generator().manual_seed(0), device=cuda).items()}
        before = (cin_interact.LAUNCHES, cin_interact.BWD_LAUNCHES)
        out = cin.apply(p, x, training=True, generator=torch.Generator(device=cuda).manual_seed(3))
        out.sum().backward()
        torch.cuda.synchronize()
        assert (cin_interact.LAUNCHES - before[0], cin_interact.BWD_LAUNCHES - before[1]) == \
            ((4, 2) if remat else (2, 2))
        grads.append({k: v.grad for k, v in p.items()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k])


@pytest.mark.parametrize("name", ["adam", "adam_bf16m", "adagrad", "momentum", "lamb",
                                  "rowwise_adam"])
def test_optimizer_with_a_schedule_on_card_matches_cpu(cuda, name):
    """Each optimizer with a warmup-plus-cosine schedule on CUDA params: the
    count stays on the CPU (the schedule is read on the host without
    waiting for the card), and 3 updates match the CPU's to 1e-5 of
    max|ref| (sqrt, rsqrt and norms round apart on the two devices)."""
    from recman_tpu_torch.training import apply_updates, create_optimizer, warmup_schedule

    gen = torch.Generator().manual_seed(9)
    params = {"t_feat_embed": torch.randn(40, 4, generator=gen), "w": torch.randn(6, 3, generator=gen),
              "v": torch.randn(3, generator=gen)}
    grads = [{k: torch.randn(v.shape, generator=gen) for k, v in params.items()} for _ in range(3)]
    out = []
    for dev in ("cpu", cuda):
        opt = create_optimizer(name, warmup_schedule(1e-2, 1, 3, decay="cosine"))
        p = {k: v.to(dev) for k, v in params.items()}
        st = opt.init(p)
        for g in grads:
            u, st = opt.update({k: v.to(dev) for k, v in g.items()}, st, p)
            p = apply_updates(p, u)
        out.append(p)
    for k in params:
        _close(out[0][k], out[1][k].cpu(), 1e-5)
