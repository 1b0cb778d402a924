"""The port's whole-chain CIN (recman_tpu_torch/ops/cin_chain.py) against
the JAX package's ``cin_chain_fm``, which runs its Pallas kernels in
interpret mode on the CPU (as tests/test_cin_chain.py runs them).

Tolerances: both sides round x0, xk, z and W to bf16 at the same places
and accumulate in f32, so only the order of the f32 sums differs — and,
rarely, an xk value of a later layer that lands on the other side of a
bf16 rounding boundary. 1e-4 of the largest pooled value covers both in
the forward. The backward (K2's twin against ``jax.vjp``) is held to
1e-3 of the largest element of dx0, each dW_i and each db_i: gpre is
rounded to bf16 after f32 sums whose order differs, so an element can
land one bf16 step (2^-8 relative) away and carry that into the sums.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recman_tpu.ops import cin_chain as jax_chain
from recman_tpu_torch.ops import cin_chain as torch_chain
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

ACTS = ["identity", "relu", "leaky_relu"]


def _inputs(h0, units, b, d, seed):
    """x0c (h0, b*d), per-layer W (h0*hk, o) at Glorot scale, and b (o,)."""
    rs = np.random.RandomState(seed)
    x0c = rs.randn(h0, b * d).astype(np.float32)
    ws, bs, hk = [], [], h0
    for o in units:
        ws.append((rs.randn(h0 * hk, o) * np.sqrt(2.0 / (h0 * hk + o))).astype(np.float32))
        bs.append((0.1 * rs.randn(o)).astype(np.float32))
        hk = o // 2
    return x0c, ws, bs


def _run_both(h0, units, b, d, act, seed=0):
    x0c, ws, bs = _inputs(h0, units, b, d, seed)
    ref = jax_chain.cin_chain_fm(
        jnp.asarray(x0c), [jnp.asarray(w) for w in ws],
        [jnp.asarray(v) for v in bs], units, d, act,
    )
    got = torch_chain.cin_chain_fm(
        torch.from_numpy(x0c), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(v) for v in bs], units, d, act,
    )
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_close(ref, got, rel=1e-4):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.shape == g.shape and g.dtype == np.float32
        err = np.abs(r - g).max()
        assert err <= rel * np.abs(r).max(), (err, np.abs(r).max())


# B*D must be a multiple of 128 for the reference's chain tiles
B, F, D = 64, 5, 4


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("units", [(6, 4), (8, 8, 6), (4,)])
def test_plain_chain_matches_jax_interpret(act, units):
    ref, got = _run_both(F, units, B, D, act, seed=3)
    _assert_close(ref, got)


def test_plain_chain_matches_jax_interpret_d16():
    ref, got = _run_both(6, (8, 6), 16, 16, "leaky_relu", seed=5)
    _assert_close(ref, got)


@pytest.mark.parametrize(
    "h0,units,d,bd,act",
    [
        (5, (6, 4), 4, 256, "leaky_relu"),
        (26, (100, 100), 16, 131072, "leaky_relu"),
        (26, (100, 100), 16, 131072, "sigmoid"),   # activation outside the chain
        (5, (7, 4), 4, 256, "relu"),                # odd non-final width
        (5, (6, 4), 4, 200, "relu"),                # B*D not tileable
        (5, (6, 4), 10, 1280, "identity"),          # D does not divide the tiles
        (130, (6,), 4, 256, "relu"),                # H0 over 128
        (5, (600,), 4, 256, "relu"),                # O over 512
        (5, (300, 8), 4, 256, "relu"),              # Hk = 150 over 128
        (5, (), 4, 256, "relu"),                    # no layers
        (8, (100, 100, 100), 8, 128, "identity"),
        (8, (100,), 2048, 2048, "relu"),            # D = tile width
    ],
)
def test_chain_supported_matches_jax(h0, units, d, bd, act):
    assert torch_chain.chain_supported(h0, units, d, bd, act) == \
        jax_chain.chain_supported(h0, units, d, bd, act)


@pytest.mark.parametrize("d", [1, 2, 8, 16, 128, 256, 1024, 2048, 10, 96])
@pytest.mark.parametrize("units", [(6, 4), (256, 512), (258, 4), (513,), (100,) * 9, ()])
def test_chain_range_is_the_reference_rule(units, d):
    """``chain_unsupported_reason`` states the reference's ``chain_supported``
    clause by clause: None exactly where the reference takes its chain."""
    for h0 in (1, 26, 128, 129):
        for bd in (64, 128, 1024, 2048, 3072, 4096):
            ours = torch_chain.chain_unsupported_reason(h0, units, d, bd) is None
            assert ours == jax_chain.chain_supported(h0, units, d, bd, "relu"), (h0, bd)


def test_bench_geometry_is_in_k1_range():
    """The bench chain, and the corners of the reference chain's range, are
    in K1's: the widest maps and fields, the widest D, nine layers."""
    for h0, units, d, bd in [(26, (100, 100), 16, 8192 * 16), (26, (256, 256, 256), 16, 1024),
                             (128, (256, 512), 1024, 1024), (1, (2,), 1, 128),
                             (5, (100,) * 9, 256, 512)]:
        assert torch_chain.chain_unsupported_reason(h0, units, d, bd) is None
        assert torch_chain.chain_supported(h0, units, d, bd, "relu")


# the edges of the range: D 2048, B*D off the tiles, O 513, fan-in 129
# (H0, and Hk through a non-final O of 258)
@pytest.mark.parametrize(
    "h0,units,d,bd,match",
    [
        (5, (6, 4), 2048, 2048, "power of two up to 1024"),
        (5, (6, 4), 4, 64, r"multiple of max\(128, D\)"),
        (5, (513,), 4, 256, "O_i <= 512"),
        (129, (6,), 4, 256, "Hk_i <= 128"),
        (5, (258, 4), 4, 256, "Hk_i <= 128"),
    ],
)
def test_k1_wrapper_rejects_geometry_outside_its_range(h0, units, d, bd, match):
    x0c, ws, bs = _inputs(h0, units, bd // d, d, seed=0)
    with pytest.raises(ValueError, match=match):
        torch_chain._cin_chain_fm_cuda(
            torch.from_numpy(x0c), [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(v) for v in bs], units, d, "relu",
        )


def test_k1_wrapper_rejects_wrong_dtype_and_layout():
    x0c, ws, bs = _inputs(5, (6, 4), 64, 4, seed=0)
    x = torch.from_numpy(x0c)
    w = [torch.from_numpy(v) for v in ws]
    b = [torch.from_numpy(v) for v in bs]
    with pytest.raises(ValueError, match="contiguous"):
        torch_chain._cin_chain_fm_cuda(x.double(), w, b, (6, 4), 4, "relu")
    with pytest.raises(ValueError, match="contiguous"):
        torch_chain._cin_chain_fm_cuda(x.t().contiguous().t(), w, b, (6, 4), 4, "relu")
    with pytest.raises(ValueError, match="float32"):
        torch_chain._cin_chain_fm_cuda(x, [v.half() for v in w], b, (6, 4), 4, "relu")
    with pytest.raises(ValueError, match="layer shapes"):
        torch_chain._cin_chain_fm_cuda(x, w[::-1], b, (6, 4), 4, "relu")
    with pytest.raises(ValueError, match="activation"):
        torch_chain._cin_chain_fm_cuda(x, w, b, (6, 4), 4, "sigmoid")


def test_cpu_path_does_not_count_launches():
    before = torch_chain.LAUNCHES
    _run_both(F, (6, 4), B, D, "relu")
    assert torch_chain.LAUNCHES == before


BWD_CASES = [(F, units, B, D, act) for units in [(6, 4), (8, 8, 6), (4,)] for act in ACTS] + [
    (6, (8, 6), 16, 16, "leaky_relu"),
]


@pytest.fixture(scope="module")
def jax_bwd():
    """JAX's interpreted chain with saved fmaps and ``jax.vjp`` of
    ``cin_chain_fm`` (CHAIN_SAVE_FMAPS, the default) for every case, once."""
    assert jax_chain.CHAIN_SAVE_FMAPS
    out = {}
    for case in BWD_CASES:
        h0, units, b, d, act = case
        x0c, ws, bs = _inputs(h0, units, b, d, seed=len(units) + d)
        gs = _cotangents(h0, units, b, seed=7)
        jx, jw, jb = jnp.asarray(x0c), [jnp.asarray(w) for w in ws], [jnp.asarray(v) for v in bs]
        fwd = jax_chain._chain_fwd_pallas(jx, jw, jb, units, d, act, interpret=True, save=True)
        _, vjp = jax.vjp(lambda x, w, v: jax_chain.cin_chain_fm(x, w, v, units, d, act), jx, jw, jb)
        dx0, dws, dbs = vjp(tuple(jnp.asarray(g) for g in gs))
        out[case] = {
            "inputs": (x0c, ws, bs, gs),
            "fmaps": [np.asarray(f) for f in fwd[len(units):]],
            "grads": (np.asarray(dx0), [np.asarray(w) for w in dws], [np.asarray(v) for v in dbs]),
        }
    return out


def _cotangents(h0, units, b, seed):
    rs = np.random.RandomState(seed)
    cfgs = torch_chain._layer_cfgs(h0, units)
    return [rs.randn(b, c.o - c.feed).astype(np.float32) for c in cfgs]


def _rel_err(ref, got):
    return np.abs(np.asarray(ref) - np.asarray(got)).max() / np.abs(np.asarray(ref)).max()


def _case_id(case):
    h0, units, b, d, act = case
    return f"{act}-{'x'.join(map(str, units))}-d{d}"


@pytest.mark.parametrize("case", BWD_CASES, ids=_case_id)
def test_plain_save_fmaps_match_jax_interpret(jax_bwd, case):
    h0, units, b, d, act = case
    x0c, ws, bs, _ = jax_bwd[case]["inputs"]
    T = torch.from_numpy
    out = torch_chain.cin_chain_fm_reference(T(x0c), [T(w) for w in ws], [T(v) for v in bs],
                                             units, d, act, save=True)
    assert len(out) == 2 * len(units)
    for ref, got in zip(jax_bwd[case]["fmaps"], out[len(units):]):
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert _rel_err(ref, got.numpy()) <= 1e-4


@pytest.mark.parametrize("case", BWD_CASES, ids=_case_id)
def test_plain_chain_bwd_matches_jax_vjp(jax_bwd, case):
    h0, units, b, d, act = case
    x0c, ws, bs, gs = jax_bwd[case]["inputs"]
    T = torch.from_numpy
    fmaps = [T(f) for f in jax_bwd[case]["fmaps"]]
    dx0, dws, dbs = torch_chain.cin_chain_bwd(T(x0c), [T(w) for w in ws], [T(v) for v in bs],
                                              [T(g) for g in gs], fmaps, units, d, act)
    rdx0, rdws, rdbs = jax_bwd[case]["grads"]
    assert _rel_err(rdx0, dx0) <= 1e-3
    for ref, got in zip(rdws + rdbs, list(dws) + list(dbs)):
        assert got.shape == ref.shape
        assert _rel_err(ref, got) <= 1e-3


@pytest.mark.parametrize("case", BWD_CASES[:3], ids=_case_id)
def test_autograd_chain_matches_jax_vjp(jax_bwd, case):
    """cin_chain_fm's autograd Function (save forward + backward twin)."""
    h0, units, b, d, act = case
    x0c, ws, bs, gs = jax_bwd[case]["inputs"]
    x = torch.from_numpy(x0c).requires_grad_()
    w = [torch.from_numpy(v).requires_grad_() for v in ws]
    bb = [torch.from_numpy(v).requires_grad_() for v in bs]
    pooled = torch_chain.cin_chain_fm(x, w, bb, units, d, act)
    torch.autograd.backward(pooled, [torch.from_numpy(g) for g in gs])
    rdx0, rdws, rdbs = jax_bwd[case]["grads"]
    assert _rel_err(rdx0, x.grad) <= 1e-3
    for ref, got in zip(rdws + rdbs, w + bb):
        assert _rel_err(ref, got.grad) <= 1e-3


def test_no_grad_forward_saves_nothing():
    x0c, ws, bs = _inputs(F, (6, 4), B, D, seed=1)
    T = torch.from_numpy
    with torch.no_grad():
        out = torch_chain.cin_chain_fm(T(x0c).requires_grad_(), [T(w) for w in ws],
                                       [T(v) for v in bs], (6, 4), D, "relu")
    assert len(out) == 2 and all(o.grad_fn is None for o in out)


@pytest.mark.parametrize(
    "h0,units,d,bd,match",
    [
        (5, (6, 4), 12, 1536, "power of two"),
        (5, (513,), 4, 256, "O_i <= 512"),
        (129, (256,), 4, 256, "Hk_i <= 128"),
    ],
)
def test_k2_wrapper_rejects_geometry_outside_its_range(h0, units, d, bd, match):
    x0c, ws, bs = _inputs(h0, units, bd // d, d, seed=0)
    T = torch.from_numpy
    with pytest.raises(ValueError, match=match):
        torch_chain._cin_chain_bwd_cuda(T(x0c), [T(w) for w in ws], [], [], units, d, "relu")


def test_k2_wrapper_rejects_wrong_cotangent_shape():
    x0c, ws, bs = _inputs(F, (6, 4), B, D, seed=0)
    T = torch.from_numpy
    fmaps = [torch.zeros((o, B * D)) for o in (6, 4)]
    gs = [torch.zeros((B, 3)), torch.zeros((B, 5))]
    with pytest.raises(ValueError, match="pooled cotangent"):
        torch_chain._cin_chain_bwd_cuda(T(x0c), [T(w) for w in ws], gs, fmaps, (6, 4), D, "relu")


def test_bench_geometry_is_in_k2_range():
    assert torch_chain.chain_unsupported_reason(26, (100, 100), 16, 8192 * 16) is None


def test_widest_k1_geometry_is_in_k2_range():
    assert torch_chain.chain_unsupported_reason(39, (256, 128), 8, 1024) is None
    assert torch_chain.chain_unsupported_reason(128, (256, 256), 8, 1024) is None


# (H0, units, B, D, act): the edges of the chain's range: a final layer of
# 512 maps (two passes of 256 on the card), D 256 and 1024 (tiles of 128
# columns a batch row), nine layers
RANGE_CASES = [(3, (8, 512), 32, 4, "relu"), (5, (6, 4), 2, 256, "leaky_relu"),
               (4, (8, 6), 1, 1024, "identity"), (4, (8,) * 8 + (6,), 32, 4, "leaky_relu")]


@pytest.mark.parametrize("case", RANGE_CASES, ids=_case_id)
def test_plain_chain_matches_jax_at_the_range_edges(case):
    """K1's twin (pooled blocks and fmaps) against the interpreted
    ``_chain_fwd_pallas`` to 1e-4, and K2's twins, both forms, against
    ``jax.vjp`` of ``cin_chain_fm`` to 1e-3, at the edges of the range."""
    h0, units, b, d, act = case
    x0c, ws, bs = _inputs(h0, units, b, d, seed=len(units) + d)
    gs = _cotangents(h0, units, b, seed=7)
    jx, jw, jb = jnp.asarray(x0c), [jnp.asarray(w) for w in ws], [jnp.asarray(v) for v in bs]
    ref_fwd = jax_chain._chain_fwd_pallas(jx, jw, jb, units, d, act, interpret=True, save=True)
    _, vjp = jax.vjp(lambda x, w, v: jax_chain.cin_chain_fm(x, w, v, units, d, act), jx, jw, jb)
    rdx0, rdws, rdbs = vjp(tuple(jnp.asarray(g) for g in gs))
    T = torch.from_numpy
    args = (T(x0c), [T(w) for w in ws], [T(v) for v in bs])
    got = torch_chain.cin_chain_fm_reference(*args, units, d, act, save=True)
    assert len(got) == 2 * len(units)
    for ref, g in zip(ref_fwd, got):
        assert g.shape == ref.shape and _rel_err(ref, g.numpy()) <= 1e-4
    fmaps = got[len(units):]
    for bwd in (torch_chain.cin_chain_bwd(*args, [T(g) for g in gs], fmaps, units, d, act),
                torch_chain.cin_chain_bwd_recompute(*args, [T(g) for g in gs], units, d, act)):
        dx0, dws, dbs = bwd
        assert _rel_err(rdx0, dx0) <= 1e-3
        for ref, g in zip(list(rdws) + list(rdbs), list(dws) + list(dbs)):
            assert g.shape == ref.shape and _rel_err(ref, g) <= 1e-3


# -- K2's recompute form (CHAIN_SAVE_FMAPS = False) -----------------------------

RECOMPUTE_CASES = BWD_CASES[:3] + BWD_CASES[-1:]


@pytest.mark.parametrize("case", RECOMPUTE_CASES, ids=_case_id)
def test_plain_recompute_matches_jax_interpret_without_fmaps(case):
    """The recompute form's twin against the interpreted ``_chain_bwd_pallas``
    with no fmaps (which rebuilds them in its kernel) to 1e-3 of max|ref|,
    and bit-equal to the save form's twin on K1's twin's fmaps."""
    h0, units, b, d, act = case
    x0c, ws, bs = _inputs(h0, units, b, d, seed=len(units) + d + 1)
    gs = _cotangents(h0, units, b, seed=8)
    ref = jax_chain._chain_bwd_pallas(jnp.asarray(x0c), [jnp.asarray(w) for w in ws],
                                      [jnp.asarray(v) for v in bs], [jnp.asarray(g) for g in gs],
                                      units, d, act, interpret=True, fmaps=())
    T = torch.from_numpy
    args = (T(x0c), [T(w) for w in ws], [T(v) for v in bs], [T(g) for g in gs])
    before = torch_chain.RECOMPUTE_LAUNCHES
    got = torch_chain.cin_chain_bwd_recompute(*args, units, d, act)
    assert torch_chain.RECOMPUTE_LAUNCHES == before  # the CPU runs the twin
    for r, g in zip([ref[0], *ref[1], *ref[2]], [got[0], *got[1], *got[2]]):
        assert g.shape == r.shape and _rel_err(r, g) <= 1e-3
    fmaps = torch_chain.cin_chain_fm_reference(*args[:3], units, d, act, save=True)[len(units):]
    saved = torch_chain.cin_chain_bwd(*args, fmaps, units, d, act)
    assert all(torch.equal(a, c) for a, c in zip([saved[0], *saved[1], *saved[2]],
                                                 [got[0], *got[1], *got[2]]))


@pytest.mark.parametrize("save", [True, False])
def test_chain_save_fmaps_flag_picks_the_form(save, monkeypatch):
    """``CHAIN_SAVE_FMAPS`` is read when the forward runs: True keeps the
    fmaps for K2's save form, False only x0c and the params (the
    reference's residuals) for the recompute form; the gradients are the
    same bits."""
    h0, units, b, d = F, (8, 8, 6), B, D
    x0c, ws, bs = _inputs(h0, units, b, d, seed=3)
    gs = [torch.from_numpy(g) for g in _cotangents(h0, units, b, seed=4)]
    grads = []
    for flag in (True, save):
        monkeypatch.setattr(torch_chain, "CHAIN_SAVE_FMAPS", flag)
        leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (x0c, *ws, *bs)]
        pooled = torch_chain.cin_chain_fm(leaves[0], leaves[1:4], leaves[4:], units, d)
        monkeypatch.setattr(torch_chain, "CHAIN_SAVE_FMAPS", not flag)  # read in the forward
        fn = pooled[0].grad_fn
        assert type(fn).__name__ == ("_ChainFmBackward" if flag else "_ChainFmRecomputeBackward")
        assert len(fn.saved_tensors) == 1 + len(units) * (1 if flag else 2) + (
            len(units) if flag else 0)
        torch.autograd.backward(pooled, gs)
        grads.append([t.grad for t in leaves])
    assert all(torch.equal(a, c) for a, c in zip(*grads))


def test_the_chain_ignores_cin_remat(monkeypatch):
    """As in the reference (recman_tpu/layers/cin.py:199-219), ``remat``
    leaves the chain as it is: the save form with saved fmaps, never the
    recompute form."""
    from recman_tpu_torch.layers import CIN

    calls = {"save": 0, "recompute": 0}
    for key, fn in (("save", torch_chain._ChainFm), ("recompute", torch_chain._ChainFmRecompute)):
        monkeypatch.setattr(fn, "apply", classmethod(
            lambda cls, *a, _k=key, _real=fn.apply: calls.__setitem__(_k, calls[_k] + 1) or _real(*a)))
    grads = []
    for remat in (False, True):
        cin = CIN(5, (6, 4), "relu", (1, 1, 1), remat=remat)
        p = {k: v.requires_grad_() for k, v in
             cin.init(torch.Generator().manual_seed(0), device="cpu").items()}
        x = torch.randn((32, 5, 4), generator=torch.Generator().manual_seed(1))  # B*D 128
        cin.apply(p, x, training=True).square().sum().backward()
        grads.append({k: v.grad for k, v in p.items()})
    assert calls == {"save": 2, "recompute": 0}
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


# -- the tensor-core kernels' host-side layouts and scratch ---------------------

# (H0, units): the small odd geometry (Hk 5 and 3 pad to 8), the ML-100K
# anchor's three layers, the widest maps and the widest fields K1 takes,
# the bench geometry
LAYOUT_GEOMETRIES = [(5, (6, 4)), (6, (100, 100, 100)), (39, (256, 128)), (128, (128, 64)),
                     (26, (100, 100))]


def _r(x, m):
    return -(-x // m) * m


@pytest.mark.parametrize("h0,units", LAYOUT_GEOMETRIES)
def test_k1_weight_layouts_read_back_bf16_w(h0, units):
    """K1's per-layer W (K4's layout, (O_i, Kp_i)): column h*Hk8 + m of row
    o is bf16(W_i[h*Hk+m, o]); the padding rows of a field and the columns
    past H0*Hk8 are zero."""
    x0c, ws, bs = _inputs(h0, units, 1, 1, seed=h0)
    wts = torch_chain.k1_weight_layouts(h0, units, [torch.from_numpy(w) for w in ws])
    for cfg, w, wt in zip(torch_chain._layer_cfgs(h0, units), ws, wts):
        hk8 = _r(cfg.hk, 8)
        assert wt.dtype == torch.bfloat16 and wt.shape == (cfg.o, _r(h0 * hk8, 64))
        fields = wt[:, : h0 * hk8].reshape(cfg.o, h0, hk8)
        back = fields[:, :, : cfg.hk].permute(1, 2, 0).reshape(h0 * cfg.hk, cfg.o)
        assert torch.equal(back, torch.from_numpy(w).to(torch.bfloat16))
        assert not fields[:, :, cfg.hk:].any() and not wt[:, h0 * hk8:].any()


@pytest.mark.parametrize("h0,units", LAYOUT_GEOMETRIES)
def test_k2_weight_layouts_read_back_bf16_w(h0, units):
    """K2's per-layer W (K5's layout, (H0*Hk8, O64)): row h*Hk8 + m is
    bf16(W_i[h*Hk+m]); the padding rows of a field and the maps past O_i
    are zero."""
    x0c, ws, bs = _inputs(h0, units, 1, 1, seed=h0 + 1)
    wps = torch_chain.k2_weight_layouts(h0, units, [torch.from_numpy(w) for w in ws])
    for cfg, w, wp in zip(torch_chain._layer_cfgs(h0, units), ws, wps):
        hk8 = _r(cfg.hk, 8)
        assert wp.dtype == torch.bfloat16 and wp.shape == (h0 * hk8, _r(cfg.o, 64))
        fields = wp.reshape(h0, hk8, -1)
        back = fields[:, : cfg.hk, : cfg.o].reshape(h0 * cfg.hk, cfg.o)
        assert torch.equal(back, torch.from_numpy(w).to(torch.bfloat16))
        assert not fields[:, cfg.hk:].any() and not wp[:, cfg.o:].any()


def _padded_z(x0c, xk, hk8):
    """z with Hk padded to hk8 zero rows per field, (H0*Hk8, B*D) f32."""
    h0, bd = x0c.shape
    z = torch.zeros((h0, hk8, bd), dtype=torch.bfloat16)
    z[:, : xk.shape[0]] = x0c.to(torch.bfloat16)[:, None, :] * xk.to(torch.bfloat16)[None, :, :]
    return z.reshape(h0 * hk8, bd).float()


# (H0, units, B, D): the layout geometries at batches small enough for the CPU
PADDED_CASES = [(5, (6, 4), 64, 4), (6, (100, 100, 100), 16, 8), (39, (256, 128), 8, 8),
                (128, (128, 64), 2, 8), (26, (100, 100), 16, 16)]


@pytest.mark.parametrize("h0,units,b,d", PADDED_CASES)
def test_plain_contraction_over_k1_layout_matches_reference(h0, units, b, d):
    """The forward as K1 computes it, over its padded layout (z with Hk8
    rows a field, W in K4's layout): the same pooled blocks and fmaps as
    ``cin_chain_fm_reference``, to f32 sum order (1e-5 of max|ref|)."""
    T = torch.from_numpy
    x0c, ws, bs = _inputs(h0, units, b, d, seed=h0 + d)
    x0c, ws, bs = T(x0c), [T(w) for w in ws], [T(v) for v in bs]
    ref = torch_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, "leaky_relu", save=True)
    xk, outs, fmaps = x0c, [], []
    for cfg, wt, bias in zip(torch_chain._layer_cfgs(h0, units),
                             torch_chain.k1_weight_layouts(h0, units, ws), bs):
        hk8 = _r(cfg.hk, 8)
        pre = wt[:, : h0 * hk8].float() @ _padded_z(x0c, xk, hk8) + bias[:, None]
        fmap = torch_chain._act("leaky_relu", pre)
        direct = fmap[cfg.feed:]
        outs.append(direct.reshape(direct.shape[0], b, d).sum(2).t())
        fmaps.append(fmap)
        xk = fmap[: cfg.feed]
    for r, g in zip(ref, outs + fmaps):
        assert g.shape == r.shape and _rel_err(r.numpy(), g.numpy()) <= 1e-5


@pytest.mark.parametrize("h0,units,b,d", PADDED_CASES)
def test_plain_contraction_over_k2_layout_matches_reference(h0, units, b, d):
    """The backward as K2 computes it, over its padded layouts (u from W in
    K5's layout, dW from z with Hk8 rows a field): the same dx0, dW_i and
    db_i as ``cin_chain_bwd_reference``, to f32 sum order (1e-5 of
    max|ref|)."""
    T = torch.from_numpy
    x0c, ws, bs = _inputs(h0, units, b, d, seed=h0 + d + 1)
    x0c, ws, bs = T(x0c), [T(w) for w in ws], [T(v) for v in bs]
    gs = [T(g) for g in _cotangents(h0, units, b, seed=h0)]
    fmaps = torch_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, "leaky_relu",
                                               save=True)[len(units):]
    ref = torch_chain.cin_chain_bwd_reference(x0c, ws, bs, gs, fmaps, units, d, "leaky_relu")
    cfgs = torch_chain._layer_cfgs(h0, units)
    wps = torch_chain.k2_weight_layouts(h0, units, ws)
    dx0, dws, dbs, dxk_next = torch.zeros_like(x0c), [None] * len(cfgs), [None] * len(cfgs), None
    for i in reversed(range(len(cfgs))):
        cfg, hk8 = cfgs[i], _r(cfgs[i].hk, 8)
        g_direct = gs[i].t().repeat_interleave(d, dim=1)
        dfmap = g_direct if cfg.final else torch.cat([dxk_next, g_direct], 0)
        gpre = dfmap * torch.where(fmaps[i] > 0, 1.0, 0.2)
        dbs[i] = gpre.sum(1)
        gpre_bf = gpre.to(torch.bfloat16).float()
        xk = x0c if i == 0 else fmaps[i - 1][: cfg.hk]
        dw = (_padded_z(x0c, xk, hk8) @ gpre_bf.t()).reshape(h0, hk8, cfg.o)
        dws[i] = dw[:, : cfg.hk].reshape(h0 * cfg.hk, cfg.o)
        u = (wps[i][:, : cfg.o].float() @ gpre_bf).reshape(h0, hk8, -1)[:, : cfg.hk]
        dx0 = dx0 + (u * xk[None]).sum(1)
        dxk = (u * x0c[:, None]).sum(0)
        if i == 0:
            dx0 = dx0 + dxk
        else:
            dxk_next = dxk
    for r, g in zip([ref[0], *ref[1], *ref[2]], [dx0, *dws, *dbs]):
        assert g.shape == r.shape and _rel_err(r.numpy(), g.numpy()) <= 1e-5


def test_k2_scratch_shapes_at_the_bench_geometry():
    """K2's scratch at batch 8192: bf16(gpre) per layer for the dW phase
    (which reads x0 and xk in f32, with no copy), partial db per 128-column
    block, partial dW per split."""
    shapes = torch_chain.k2_scratch_shapes(26, (100, 100), 8192 * 16, [24, 11])
    assert shapes == {
        "gb": [(100, 131_072), (100, 131_072)],
        "pdb": (1024, 200),
        "pdw": [(24, 676, 100), (11, 1300, 100)],
    }


def test_plain_chain_takes_given_feeds():
    """``feeds`` replaces each later layer's xk by the feed rows of a given
    fmap: its own fmaps give the same bits, and zero feeds leave layer 0 as
    it is and make layer 1's fmap act(b_1)."""
    T = torch.from_numpy
    units, d = (8, 8, 6), D
    x0c, ws, bs = _inputs(F, units, B, d, seed=5)
    x0c, ws, bs = T(x0c), [T(w) for w in ws], [T(v) for v in bs]
    own = torch_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, "relu", save=True)
    again = torch_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, "relu", save=True,
                                               feeds=own[3:])
    assert all(torch.equal(a, b) for a, b in zip(own, again))
    zero = [torch.zeros_like(f) for f in own[3:]]
    got = torch_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, "relu", save=True, feeds=zero)
    assert torch.equal(got[3], own[3]) and torch.equal(got[0], own[0])
    assert torch.equal(got[4], torch.relu(bs[1])[:, None].expand(8, B * d))
