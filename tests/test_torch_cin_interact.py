"""The port's per-layer CIN path (recman_tpu_torch/ops/cin_interact.py,
layers/cin.py), the streaming AUC and the Criteo example against the JAX
package on the CPU.

The JAX side runs as tests/test_cin_interact.py runs it: under
``fused_grad(True), pallas_cin(True)`` its per-layer Pallas kernels K4
(``_fwd_kernel``) and K5 (``_bwd_kernel``) run in interpret mode. The
port's side runs K4's and K5's plain twins, which the card's kernels are
held to in tests/test_torch_cuda_kernels.py.

Tolerances, each of the largest element of the reference tensor, no
looser than tests/test_torch_cin_chain.py's:

- forward (K4's twin, a CIN's output, predictions) 1e-4: both sides round
  x0, xk, z and W to bf16 at the same places and sum in f32, in another
  order; a later layer's xk can land on the other side of a bf16 rounding
  boundary;
- backward (K5's twin, every gradient) 1e-3: g rounds to bf16 after f32
  sums in another order, so an element can land one bf16 step away;
- the xDeepFM loss 1e-6 relative; ``Trainer.fit`` 1e-4 relative loss and
  1e-4 absolute predictions (tests/test_torch_trainer.py's bounds: Adam
  moves a param by about lr whatever the size of a near-zero gradient).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import recman_tpu
import recman_tpu_torch
from recman_tpu.layers import CIN as JaxCIN
from recman_tpu.layers import cin as jax_cin_layer
from recman_tpu.models import XDeepFM as JaxXDeepFM
from recman_tpu.ops import cin_interact as jax_ci
from recman_tpu.ops import embedding as jax_emb
from recman_tpu.training import LogLoss as JaxLogLoss
from recman_tpu.training import RocAucScore as JaxRocAucScore
from recman_tpu.training import Trainer as JaxTrainer
from recman_tpu.training import auc as jax_auc
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.data import synthetic_criteo_arrays
from recman_tpu_torch.layers import CIN
from recman_tpu_torch.layers import cin as torch_cin_layer
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.ops import cin_chain
from recman_tpu_torch.ops import cin_interact as torch_ci
from recman_tpu_torch.ops import embedding as torch_emb
from recman_tpu_torch.training import LogLoss, StreamingAUC, Trainer
from recman_tpu_torch.training import auc as torch_auc
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

FWD_TOL, BWD_TOL = 1e-4, 1e-3
T = torch.from_numpy


def _jax_kernels():
    """The JAX package's per-layer Pallas path, interpreted on the CPU."""
    stack = contextlib.ExitStack()
    stack.enter_context(jax_emb.fused_grad(True))
    stack.enter_context(jax_ci.pallas_cin(True))
    return stack


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / np.abs(ref).max()


def _interact_inputs(h0, hk, o, bd, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(h0, bd).astype(np.float32), rs.randn(hk, bd).astype(np.float32),
            (rs.randn(h0 * hk, o) * np.sqrt(2.0 / (h0 * hk + o))).astype(np.float32),
            rs.randn(o, bd).astype(np.float32))


# (H0, Hk, O, B*D, shared): Hk <= 32 and 32 < Hk <= 64 are the TPU
# kernel's two sublane groupings; "shared" passes x0c as xkc (layer 0)
INTERACT_CASES = [(5, 3, 8, 64, False), (5, 40, 8, 8, False), (4, 4, 6, 40, True),
                  (3, 100, 12, 32, False)]


@pytest.mark.parametrize("h0,hk,o,bd,shared", INTERACT_CASES)
def test_k4_twin_matches_jax_interpret(h0, hk, o, bd, shared):
    x0c, xkc, w, _ = _interact_inputs(h0, hk, o, bd, seed=h0 + hk)
    if shared:
        xkc = x0c
    ref = jax_ci._pallas_fwd(jnp.asarray(x0c), jnp.asarray(xkc), jnp.asarray(w), interpret=True)
    got = torch_ci.cin_interact_fm_reference(T(x0c), T(xkc), T(w))
    assert got.dtype == torch.float32 and _rel(ref, got) <= FWD_TOL


@pytest.mark.parametrize("h0,hk,o,bd,shared", INTERACT_CASES)
def test_k5_twin_matches_jax_interpret(h0, hk, o, bd, shared):
    x0c, xkc, w, g = _interact_inputs(h0, hk, o, bd, seed=h0 + hk + 1)
    if shared:
        xkc = x0c
    refs = jax_ci._pallas_bwd(jnp.asarray(x0c), jnp.asarray(xkc), jnp.asarray(w),
                              jnp.asarray(g), interpret=True)
    gots = torch_ci.cin_interact_fm_bwd_reference(T(x0c), T(xkc), T(w), T(g))
    for ref, got in zip(refs, gots):  # dx0, dxk, dW
        assert _rel(ref, got) <= BWD_TOL


# (H0, Hk, O): Hk a multiple of 8 or not, O a multiple of 64 or not, H0
# past K4's 64 fields a launch
LAYOUT_CASES = [(5, 3, 8), (26, 100, 200), (3, 13, 264), (2, 128, 512), (130, 1, 4)]


@pytest.mark.parametrize("h0,hk,o", LAYOUT_CASES)
def test_k4_weight_layout_reads_back_bf16_w(h0, hk, o):
    """K4's W layout (O, Kp): column h*Hk8 + m of row o is bf16(W[h*Hk+m,
    o]); padding rows of a field and columns past H0*Hk8 are zero."""
    w = T(_interact_inputs(h0, hk, o, 1, seed=h0 + o)[2])
    wt = torch_ci.k4_weight_layout(w, h0, hk)
    hk8 = -(-hk // 8) * 8
    assert wt.dtype == torch.bfloat16 and wt.shape == (o, -(-h0 * hk8 // 64) * 64)
    fields = wt[:, : h0 * hk8].reshape(o, h0, hk8)
    back = fields[:, :, :hk].permute(1, 2, 0).reshape(h0 * hk, o)
    assert torch.equal(back, w.to(torch.bfloat16))
    assert not fields[:, :, hk:].any() and not wt[:, h0 * hk8:].any()


@pytest.mark.parametrize("h0,hk,o", LAYOUT_CASES)
def test_k5_weight_layout_reads_back_bf16_w(h0, hk, o):
    """K5's W layout (H0*Hk8, O64): row h*Hk8 + m is bf16(W[h*Hk+m]); the
    padding rows of a field and the columns past O are zero."""
    w = T(_interact_inputs(h0, hk, o, 1, seed=h0 + o + 1)[2])
    wp = torch_ci.k5_weight_layout(w, h0, hk)
    hk8 = -(-hk // 8) * 8
    assert wp.dtype == torch.bfloat16 and wp.shape == (h0 * hk8, -(-o // 64) * 64)
    fields = wp.reshape(h0, hk8, -1)
    assert torch.equal(fields[:, :hk, :o].reshape(h0 * hk, o), w.to(torch.bfloat16))
    assert not fields[:, hk:].any() and not wp[:, o:].any()


@pytest.mark.parametrize("shared", [False, True])
def test_cin_interact_fm_grads_match_jax_grad(shared):
    """The autograd Function (K4's twin forward, K5's twin backward)
    against ``jax.grad`` through the reference's custom_vjp; with a shared
    input autograd sums dx0 and dxk, as the custom_vjp's caller does."""
    x0c, xkc, w, c = _interact_inputs(5, 5 if shared else 6, 7, 48, seed=9)

    def jloss(x0, xk, w):
        return jnp.sum(jnp.tanh(jax_ci.cin_interact_fm(x0, x0 if shared else xk, w)) * c)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x0c), jnp.asarray(xkc), jnp.asarray(w))
    x0, xk, ww = (T(a.copy()).requires_grad_() for a in (x0c, xkc, w))
    out = torch_ci.cin_interact_fm(x0, x0 if shared else xk, ww)
    (torch.tanh(out) * T(c)).sum().backward()
    assert _rel(ref[0], x0.grad) <= BWD_TOL and _rel(ref[2], ww.grad) <= BWD_TOL
    if not shared:
        assert _rel(ref[1], xk.grad) <= BWD_TOL


def _cin_pair(units, d, b=16, h0=5, act="leaky_relu", seed=0):
    """A JAX and a port CIN, the JAX init params (biases random so they
    take part), inputs (B, H0, D) and an output cotangent, as numpy."""
    jc = JaxCIN(h0, units, act, (1,) * (len(units) + 1))
    tc = CIN(h0, units, act, (1,) * (len(units) + 1))
    rs = np.random.RandomState(seed)
    params = {k: np.asarray(v) for k, v in jc.init(jax.random.PRNGKey(seed)).items()}
    for k, v in params.items():
        if not v.any():
            params[k] = (0.1 * rs.randn(*v.shape)).astype(np.float32)
    x = rs.randn(b, h0, d).astype(np.float32)
    cot = rs.randn(b, 1).astype(np.float32)
    return jc, tc, params, x, cot


def _jax_cin_grads(jc, params, x, cot):
    def loss(p, x):
        return jnp.sum(jc.apply(p, x, training=False) * cot)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out = jc.apply(jp, jnp.asarray(x), training=False)
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def _port_cin_grads(tc, params, x, cot):
    tp = {k: T(v.copy()).requires_grad_() for k, v in params.items()}
    tx = T(x.copy()).requires_grad_()
    out = tc.apply(tp, tx)
    (out * T(cot)).sum().backward()
    return out.detach().numpy(), {k: v.grad.numpy() for k, v in tp.items()}, tx.grad.numpy()


def _assert_cin_match(ref, got):
    (rout, rgp, rgx), (out, gp, gx) = ref, got
    assert _rel(rout, out) <= FWD_TOL
    assert _rel(rgx, gx) <= BWD_TOL
    assert set(gp) == set(rgp)
    for k in rgp:
        assert _rel(rgp[k], gp[k]) <= BWD_TOL, k


@contextlib.contextmanager
def _chain_mode(mode):
    prev = (jax_cin_layer.CIN_CHAIN_MODE, torch_cin_layer.CIN_CHAIN_MODE)
    jax_cin_layer.CIN_CHAIN_MODE = torch_cin_layer.CIN_CHAIN_MODE = mode
    try:
        yield
    finally:
        jax_cin_layer.CIN_CHAIN_MODE, torch_cin_layer.CIN_CHAIN_MODE = prev


@pytest.mark.parametrize("d,chain_mode", [(10, "auto"), (8, "off")])
def test_per_layer_cin_matches_jax_per_layer_path(d, chain_mode):
    """Forward and every gradient (params and input) of the per-layer
    path: D = 10 is outside the chain's tiles; at D = 8 the chain is
    switched off on both sides."""
    jc, tc, params, x, cot = _cin_pair((8, 6, 4), d)
    with _chain_mode(chain_mode):
        assert not tc._chain_eligible(False, x.shape[0], d)
        with _jax_kernels():
            ref = _jax_cin_grads(jc, params, x, cot)
        got = _port_cin_grads(tc, params, x, cot)
    _assert_cin_match(ref, got)


@pytest.mark.parametrize("units,path", [((100, 257), "chain"), ((100, 300), "batch_major")])
def test_wide_final_layer_routes_off_k1(units, path, monkeypatch):
    """A final layer of 257-512 maps passes the reference's chain rule,
    which K1 and K2 take whole. At 257 the fan-ins stay <= 128: both
    packages run their chain, and forward and gradients match. Past 257
    the final layer's half-width (the reference's ``max(field_nums)``)
    exceeds 128 and both run batch-major, where forward and gradients
    match too."""
    jc, tc, params, x, cot = _cin_pair(units, 8)
    assert cin_chain.chain_supported(5, units, 8, x.shape[0] * 8, "leaky_relu")
    assert cin_chain.chain_unsupported_reason(5, units, 8, x.shape[0] * 8) is None
    calls = _spy(monkeypatch)
    with _jax_kernels():
        ref = _jax_cin_grads(jc, params, x, cot)
    got = _port_cin_grads(tc, params, x, cot)
    assert _taken(calls) == path
    _assert_cin_match(ref, got)


# (H0, units, D, B, on the chain): the geometries of the reference chain's
# range that a port whose K1 took O <= 256, 8 layers, D dividing 128 and
# a shared-memory clause sent to the per-layer path, the bench's, and the
# edges past the range
CHAIN_ROUTING = [
    (26, (256, 256), 16, 8192, True),
    (26, (256, 256, 256), 16, 8192, True),
    (26, (256, 200), 16, 8192, True),
    (128, (256, 256), 8, 1024, True),
    (26, (100, 257), 16, 8192, True),
    (26, (100,) * 9, 16, 8192, True),
    (26, (100, 100), 256, 64, True),
    (26, (100, 100), 1024, 8, True),
    (26, (100, 100), 16, 8192, True),     # the bench's
    (26, (100, 100), 2048, 8, False),     # D past 1024
    (26, (100, 100), 10, 8192, False),    # D not a power of two
    (26, (100, 100), 16, 4, False),       # B*D off the tiles
    (26, (258, 100), 16, 64, False),      # fan-in 129
    (26, (100, 513), 16, 64, False),      # O 513
]


@pytest.mark.parametrize("h0,units,d,b,chain", CHAIN_ROUTING)
@pytest.mark.parametrize("training", [False, True])
def test_chain_routing_is_the_reference_rule(h0, units, d, b, chain, training):
    """The port's ``CIN._chain_eligible`` is the reference's, in eval and
    in training: the port takes its chain (K1, K2) exactly where the JAX
    package takes its own."""
    keep = (1,) * (len(units) + 1)
    jc = JaxCIN(h0, units, "relu", keep)
    tc = CIN(h0, units, "relu", keep)
    assert jc._chain_eligible(training, b, d) == chain
    assert tc._chain_eligible(training, b, d) == chain


# (H0, units, D, B): the widest maps at every layer, a final layer of 257
# maps, D 256 (two 128-column tiles a batch row on the card) and 9 layers
CHAIN_EDGES = [(26, (256, 256, 256), 16, 8), (5, (100, 257), 8, 16), (5, (8, 6), 256, 2),
               (6, (8,) * 8 + (6,), 4, 32)]


@pytest.mark.parametrize("h0,units,d,b", CHAIN_EDGES)
def test_chain_cin_matches_jax_chain_at_the_range_edges(h0, units, d, b, monkeypatch):
    """Forward and every gradient (params and input) of the port's CIN on
    its chain (K1's and K2's twins here) against the reference's chain,
    its Pallas kernels interpreted, at the edges of the chain's range."""
    jc, tc, params, x, cot = _cin_pair(units, d, b=b, h0=h0)
    assert tc._chain_eligible(False, b, d) and jc._chain_eligible(False, b, d)
    calls = _spy(monkeypatch)
    with _jax_kernels():
        ref = _jax_cin_grads(jc, params, x, cot)
    got = _port_cin_grads(tc, params, x, cot)
    assert _taken(calls) == "chain"
    _assert_cin_match(ref, got)


def test_batch_major_backward_rounds_as_xla():
    """The bf16 batch-major backward rounds dW, z's cotangent and the
    inputs' cotangents to bf16 where XLA's autodiff of the reference's
    einsum does (its vjp's jaxpr): at units (100, 300), D 8, B 16 the
    input's gradient and every filter and bias gradient match JAX's to
    1e-4 of max|ref|. Summed in f32 throughout, they were 4e-3 apart."""
    jc, tc, params, x, cot = _cin_pair((100, 300), 8, b=16)
    assert not torch_ci.pallas_cin_active(max(tc.field_nums))  # batch-major on both sides
    with _jax_kernels():
        ref = _jax_cin_grads(jc, params, x, cot)
    got = _port_cin_grads(tc, params, x, cot)
    assert _rel(ref[0], got[0]) <= FWD_TOL
    assert _rel(ref[2], got[2]) <= 1e-4
    for i in range(2):
        for k in (f"cin_filter_{i}", f"cin_bias_{i}"):
            assert _rel(ref[1][k], got[1][k]) <= 1e-4, k


def _spy(monkeypatch):
    """Count the calls of each path's entry in layers/cin.py."""
    calls = {"chain": 0, "per_layer": 0, "batch_major": 0}
    for key, name in (("chain", "cin_chain_fm"), ("per_layer", "cin_interact_fm"),
                      ("batch_major", "cin_interact")):
        real = getattr(torch_cin_layer, name)

        def counting(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(torch_cin_layer, name, counting)
    return calls


def _taken(calls):
    taken = [k for k, v in calls.items() if v]
    assert len(taken) == 1, calls
    return taken[0]


ROUTES = [
    # (CIN kwargs, D, training, contexts, path)
    ({}, 4, False, (), "chain"),
    ({}, 10, False, (), "per_layer"),
    ({"dropout_keep": (1, 0.5, 0.5)}, 4, True, (), "per_layer"),
    ({"dropout_keep": (1, 0.5, 0.5)}, 4, False, (), "chain"),
    ({"dropout_keep": (0.5, 1, 1)}, 4, True, (), "chain"),  # input dropout precedes the chain
    ({"activation": torch.tanh}, 4, False, (), "per_layer"),
    ({"activation": "sigmoid"}, 4, False, (), "per_layer"),
    ({"compute_dtype": "float32"}, 4, False, (), "batch_major"),
    ({"compute_dtype": "float32"}, 10, False, (), "batch_major"),
    ({"field_size": 130}, 4, False, (), "batch_major"),           # H0 over 128
    ({"cross_layer_units": (300, 4)}, 4, False, (), "batch_major"),  # Hk 150 over 128
    ({}, 4, False, ("pallas_cin_off",), "batch_major"),
    ({}, 10, False, ("fused_grad_off",), "batch_major"),
    ({}, 4, False, ("chain_off",), "per_layer"),
]


@pytest.mark.parametrize("kwargs,d,training,ctx,path", ROUTES)
def test_cin_routing(monkeypatch, kwargs, d, training, ctx, path):
    spec = {"field_size": 5, "cross_layer_units": (6, 4), "activation": "relu",
            "dropout_keep": (1, 1, 1), **kwargs}
    cin = CIN(**spec)
    params = cin.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((32, spec["field_size"], d), generator=torch.Generator().manual_seed(1))
    calls = _spy(monkeypatch)
    with contextlib.ExitStack() as stack:
        if "pallas_cin_off" in ctx:
            stack.enter_context(torch_ci.pallas_cin(False))
        if "fused_grad_off" in ctx:
            stack.enter_context(torch_emb.fused_grad(False))
        if "chain_off" in ctx:
            monkeypatch.setattr(torch_cin_layer, "CIN_CHAIN_MODE", "off")
        out = cin.apply(params, x, training=training, generator=torch.Generator().manual_seed(2))
    assert out.shape == (32, 1) and torch.isfinite(out).all()
    assert _taken(calls) == path


def test_cpu_path_counts_no_launch():
    before = (torch_ci.LAUNCHES, torch_ci.BWD_LAUNCHES)
    x0c, xkc, w, g = (T(a) for a in _interact_inputs(4, 3, 5, 16, 0))
    torch_ci.cin_interact_fwd(x0c, xkc, w)
    torch_ci.cin_interact_bwd(x0c, xkc, w, g)
    assert (torch_ci.LAUNCHES, torch_ci.BWD_LAUNCHES) == before


@pytest.mark.parametrize("d", [10, 4])
def test_remat_gradients_equal_no_remat_with_live_dropout(d):
    """Recomputing each layer in the backward reuses the layer's dropout
    mask (drawn outside the checkpoint from the explicit generator), so
    the gradients are those of the run without remat, bit for bit, on the
    per-layer (D = 10) and the batch-major (D = 4, f32) paths."""
    grads = []
    for remat in (False, True):
        cin = CIN(5, (6, 6, 4), "relu", (0.8, 0.5, 0.7, 0.6), remat=remat,
                  compute_dtype="bfloat16" if d == 10 else "float32")
        p = {k: v.requires_grad_() for k, v in
             cin.init(torch.Generator().manual_seed(0), device="cpu").items()}
        x = torch.randn((16, 5, d), generator=torch.Generator().manual_seed(1))
        out = cin.apply(p, x, training=True, generator=torch.Generator().manual_seed(2))
        out.square().sum().backward()
        grads.append({k: v.grad for k, v in p.items()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    assert any(g.abs().sum() > 0 for g in grads[0].values())


# -- xDeepFM at the paper's Criteo shape, cut small ---------------------------

SMALL_HP = {
    "embedding_size": 10,
    "cin_cross_layer_units": (8, 8, 6),
    "cin_dropout": (1, 1, 1, 1),
    "cin_activation": "leaky_relu",
    "deep_hidden_units": (16, 16),
    "deep_dropout": (1.0, 1.0, 1.0),
    "deep_l2_reg": 1e-4,
    "cin_l2_reg": 1e-4,
}
SMALL_FIELDS = ("C1", "C2", "C3", "C4", "C5")
SMALL_DENSE = ("I1", "I2")
N_SMALL, SMALL_BATCH = 192, 64


def _small_features(pkg):
    fs = pkg.FeatureSet()
    for name in SMALL_FIELDS:
        fs[name] = pkg.HashedSparseFeat(name, num_buckets=40)
    for name in SMALL_DENSE:
        fs[name] = pkg.DenseFeat(name)
    return fs


def _small_data():
    data = synthetic_criteo_arrays(N_SMALL, num_buckets=40, seed=2019)
    return {k: data[k] for k in SMALL_FIELDS + SMALL_DENSE + ("y",)}


@pytest.fixture(scope="module")
def small_models():
    jm = JaxXDeepFM(_small_features(recman_tpu), SMALL_HP)
    tm = XDeepFM(_small_features(recman_tpu_torch), SMALL_HP)
    params = {k: np.asarray(v) for k, v in jm.init_params(jax.random.PRNGKey(0)).items()}
    return jm, tm, params


def test_xdeepfm_loss_and_grads_match_jax_per_layer_path(small_models):
    jm, tm, params = small_models
    data = _small_data()
    batch = {k: v[:SMALL_BATCH] for k, v in data.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with _jax_kernels():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb, training=True, rng=None)))(jp)
    tp = {k: v.requires_grad_() for k, v in params_from_jax(params, device="cpu").items()}
    calls = {"n": 0}
    real = torch_cin_layer.CIN._apply_per_layer

    def counting(self, *a, **k):
        calls["n"] += 1
        return real(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_cin_layer.CIN, "_apply_per_layer", counting)
        tloss = tm.loss(tp, {k: torch.as_tensor(v) for k, v in batch.items()}, training=True)
    tloss.backward()
    assert calls["n"] == 1
    assert abs(tloss.item() - float(loss)) <= 1e-6 * abs(float(loss))
    for k, v in grads.items():
        assert _rel(v, tp[k].grad) <= BWD_TOL, k


def test_trainer_fit_matches_jax_per_layer_path(small_models):
    jm, tm, _ = small_models
    data = _small_data()
    x = {k: v for k, v in data.items() if k != "y"}
    jt = JaxTrainer(jm, SMALL_HP, metrics=(JaxLogLoss(),), epoch=1, batch_size=SMALL_BATCH,
                    random_seed=2019)
    params = {k: np.asarray(v) for k, v in jt.state.params.items()}
    with _jax_kernels():
        jt.fit(x, data["y"], random_seed_for_mini_batch=False)
        jpreds = jt.predict(x)
    tt = Trainer(tm, SMALL_HP, metrics=(LogLoss(),), epoch=1, batch_size=SMALL_BATCH,
                 random_seed=2019, device="cpu")
    p = params_from_jax(params, device="cpu")
    tt.state = tt.state._replace(params=p, opt_state=tt.optimizer.init(p))
    tt.fit(x, data["y"], random_seed_for_mini_batch=False)
    tpreds = tt.predict(x)
    assert tt.state.step == N_SMALL // SMALL_BATCH + 1
    assert abs(tt.last_mean_loss - jt.last_mean_loss) <= 1e-4 * abs(jt.last_mean_loss)
    assert tpreds.shape == jpreds.shape == (N_SMALL,)
    assert np.abs(tpreds - jpreds).max() <= 1e-4


def test_cin_remat_hparam_reaches_the_layer():
    fs = _small_features(recman_tpu_torch)
    assert XDeepFM(fs, dict(SMALL_HP, cin_remat=True)).cin.remat
    assert not XDeepFM(fs, SMALL_HP).cin.remat


# -- StreamingAUC ---------------------------------------------------------------


def _scores(n=3000, seed=0):
    rs = np.random.RandomState(seed)
    y = (rs.rand(n) < 0.3).astype(np.float32)
    p = np.clip(0.3 * y + 0.7 * rs.rand(n), 0, 1).astype(np.float32)
    w = (rs.rand(n) > 0.1).astype(np.float32)
    return y, p, w


@pytest.mark.parametrize("weighted", [False, True])
def test_streaming_auc_matches_jax(weighted):
    y, p, w = _scores()
    w = w if weighted else None
    js = jax_auc.update(jax_auc.init_state(512), jnp.asarray(y), jnp.asarray(p),
                        None if w is None else jnp.asarray(w), num_buckets=512)
    ts = torch_auc.update(torch_auc.init_state(512), y, p, w, num_buckets=512)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-3)
    assert abs(float(torch_auc.compute(ts)) - float(jax_auc.compute(js))) <= 1e-6
    half = torch_auc.merge(torch_auc.update(torch_auc.init_state(512), y[:1000], p[:1000],
                                            num_buckets=512),
                           torch_auc.update(torch_auc.init_state(512), y[1000:], p[1000:],
                                            num_buckets=512))
    if w is None:
        assert torch.equal(half, ts)


def test_streaming_auc_metric_matches_roc_auc():
    y, p, _ = _scores(seed=1)
    metric = StreamingAUC()
    assert str(metric) == "roc_auc" and metric.higher_the_better
    got = metric(y, p)
    assert abs(got - jax_auc.StreamingAUC()(y, p)) <= 1e-6
    assert abs(got - JaxRocAucScore()(y, p)) <= 1e-3  # 2048 score buckets
    metric.reset()
    metric.update(y[:1500], p[:1500])
    metric.update(y[1500:], p[1500:])
    assert metric.result() == pytest.approx(got, abs=1e-7)


# -- the Criteo example ---------------------------------------------------------


def test_criteo_example_runs_on_the_cpu(monkeypatch):
    from recman_tpu_torch.examples.criteo_xdeepfm import main

    calls = _spy(monkeypatch)
    trainer, (logloss, auc) = main(rows=1200, num_buckets=500, batch_size=256,
                                   embedding_size=10, device="cpu")
    assert trainer.device.type == "cpu" and trainer.state.step == 1080 // 256 + 1
    assert np.isfinite(logloss) and 0.0 < logloss < 1.0 and 0.0 <= auc <= 1.0
    assert _taken(calls) == "per_layer"
