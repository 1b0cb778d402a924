"""The port's CUDA kernels against their plain PyTorch versions on the same
CUDA tensors. These need a GPU (the kernels have no CPU or interpret
mode) and skip without one; run them on a machine with a GPU and the CUDA
toolkit. ``--noconftest`` skips tests/conftest.py, which imports JAX, so
JAX need not be installed there:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

Tolerances, per tensor, of its largest element:

- K1 (pooled blocks and saved fmaps) 1e-3: both sides round x0, xk, z and
  W to bf16 at the same places; only the order of the f32 sums differs.
- K2 (dx0, dW_i, db_i) 1e-3: gpre is rounded to bf16 after f32 sums whose
  order differs, so an element can land one bf16 step away.
- K3 1e-5, and exact zeros where no id falls: f32 sums of the same terms
  in another order.
- One stacked train step, GPU against CPU: loss 1e-5 relative, every
  gradient 1e-3 (the K2 rounding above).
"""

import numpy as np
import pytest
import torch

from recman_tpu_torch.ops import cin_chain, segment_matmul

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
        (39, (256, 128), 128, 8),  # widest maps K1 takes
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
    x0c, ws, bs = _inputs(5, (6, 4), 10, 10, 0, cuda)  # D = 10 does not divide 128
    with pytest.raises(ValueError, match="D dividing"):
        cin_chain.cin_chain_fm(x0c, ws, bs, (6, 4), 10, "relu")


def test_cin_outside_the_chain_raises_on_cuda(cuda):
    from recman_tpu_torch.layers import CIN

    cin = CIN(field_size=5, cross_layer_units=(6, 4), activation="relu",
              dropout_keep=(1, 1, 1))
    params = cin.init(torch.Generator().manual_seed(0), device=cuda)
    x = torch.randn((8, 5, 10), device=cuda)  # D = 10: not a chain geometry
    with pytest.raises(NotImplementedError, match="K4"):
        cin.apply(params, x)


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


def _close(ref, got, tol):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (ref - got).abs().max().item() <= tol * ref.abs().max().item()


CHAIN_CASES = [
    (6, (4,), 64, 4),
    (6, (8, 6), 16, 16),
    (5, (6, 4), 128, 1),
    (7, (10, 8, 6), 8, 128),
    (39, (256, 128), 128, 8),
    (26, (100, 100), 512, 16),
    (26, (100, 100), 8192, 16),  # the training geometry
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
    ref = cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act, save=True)
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


def test_k2_plan_at_the_bench_geometry(cuda):
    # x0 and dx0 tiles, xk (50 rows), W for all 104 maps (x 56), 7 warps' sums
    # in f32, gpre (100 x 132) in bf16: two blocks fit on one SM
    smem, splits = cin_chain.k2_plan(26, (100, 100), 8192 * 16, cuda)
    assert smem == ((2 * 26 + 50) * 128 + 104 * 56 + 7 * 128) * 4 + 100 * 132 * 2
    assert 2 * smem <= 228 * 1024
    assert len(splits) == 2 and all(s >= 1 for s in splits)


def test_k2_plan_takes_the_widest_k1_geometry(cuda):
    assert cin_chain.k2_plan(39, (256, 128), 1024, cuda)[0] <= 232_448


def test_k2_is_deterministic(cuda):
    units = (100, 100)
    x0c, ws, bs = _inputs(26, units, 1024, 16, 3, cuda)
    out = cin_chain.cin_chain_fwd(x0c, ws, bs, units, 16, "leaky_relu", save=True)
    gs = [torch.randn_like(p) for p in out[:2]]
    a = cin_chain.cin_chain_bwd(x0c, ws, bs, gs, out[2:], units, 16, "leaky_relu")
    b = cin_chain.cin_chain_bwd(x0c, ws, bs, gs, out[2:], units, 16, "leaky_relu")
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1] + a[2], b[1] + b[2]))


def _sorted_case(t, c, n, v, seed, device):
    rs = np.random.RandomState(seed)
    ids = np.minimum(rs.zipf(1.2, size=(t, n)) + 1, v - 1).astype(np.int32)
    sids = torch.from_numpy(np.sort(ids, axis=1)).to(device)
    sg = torch.from_numpy(rs.randn(t, c, n).astype(np.float32)).to(device)
    return sids, sg


@pytest.mark.parametrize("t,c,n,v", [(3, 5, 70, 50), (4, 17, 512, 1001), (2, 3, 5000, 7),
                                     (26, 17, 8192, 100_001)])
def test_k3_matches_plain_version(cuda, t, c, n, v):
    sids, sg = _sorted_case(t, c, n, v, t + n, cuda)
    before = segment_matmul.LAUNCHES
    got = segment_matmul.segment_matmul_from_sorted_batched(sids, sg, v)
    torch.cuda.synchronize()
    assert segment_matmul.LAUNCHES == before + 1
    ref = segment_matmul.segment_matmul_reference(sids, sg, v)
    _close(ref, got, 1e-5)
    assert torch.equal(got == 0, ref == 0)


def test_cin_with_live_dropout_raises_on_cuda_in_training(cuda):
    from recman_tpu_torch.layers import CIN

    cin = CIN(field_size=5, cross_layer_units=(6, 4), activation="relu",
              dropout_keep=(1, 0.5, 1))
    params = cin.init(torch.Generator().manual_seed(0), device=cuda)
    x = torch.randn((32, 5, 4), device=cuda)
    assert cin.apply(params, x).shape == (32, 1)  # eval: the chain
    with pytest.raises(NotImplementedError, match="K4"):
        cin.apply(params, x, training=True,
                  generator=torch.Generator(device=cuda).manual_seed(1))


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

