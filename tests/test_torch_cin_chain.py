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


def test_bench_geometry_is_in_k1_range():
    assert torch_chain.k1_unsupported_reason(26, (100, 100), 16, 8192 * 16) is None
    # x0 tile + feed rows + z chunk (26 + 50 + 50 rows of 128 f32) + W chunk (50 x 104 f32)
    assert torch_chain.k1_smem_bytes(26, (100, 100)) == 126 * 128 * 4 + 50 * 104 * 4


@pytest.mark.parametrize(
    "h0,units,d,bd,match",
    [
        (5, (6, 4), 256, 256, "D dividing"),
        (5, (6, 4), 4, 64, "multiple of 128"),
        (5, (300,), 4, 256, "O_i <= 256"),
        (5, (6,) * 9, 4, 256, "layers"),
        (128, (256, 256), 4, 256, "shared memory"),
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
        (5, (6, 4), 256, 256, "D dividing"),
        (5, (300,), 4, 256, "O_i <= 256"),
        (128, (256, 256), 4, 256, "shared memory"),
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
    assert torch_chain.k2_unsupported_reason(26, (100, 100), 16, 8192 * 16) is None


def test_widest_k1_geometry_is_in_k2_range():
    assert torch_chain.k2_unsupported_reason(39, (256, 128), 8, 1024) is None
