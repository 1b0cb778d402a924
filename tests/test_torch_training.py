"""The port's training slice (recman_tpu_torch) against the JAX package on
the CPU: numerics, dropout, Adam, the state transforms, and the stacked
xDeepFM train step at a narrow Criteo config (1000 buckets, k 16, CIN
(8, 6), DNN (32, 32), batch 64, all keeps 1).

The JAX "shipped path" is the stacked step under ``fused_grad(True)``,
``pallas_cin(True)`` and ``grad_kernel("segmat")``: its Pallas kernels
K1 (with saved fmaps), K2 and K3 run in interpret mode, by the formulas
the port's kernels follow. The JAX "f32 path" is ``fused_grad(False)``
with the per-table unrolled step (batch-major einsum CIN, scatter
backward). Tolerances:

- loss vs the shipped path 1e-6 relative: the same bf16 roundings, f32
  sums in another order;
- every gradient 1e-3 of its largest element: the CIN backward rounds
  gpre to bf16 after f32 sums whose order differs, so an element can land
  one bf16 step away (2^-8 relative) and carry that into dW and dx0;
- the 4-step loss trace 1e-5 absolute against the shipped path (the same
  arithmetic, summation order only), and 6e-3 absolute / 1% final
  relative against the f32 path (``bench.py:215``'s bounds: bf16 CIN
  multiplicands against the f32 path's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from recman_tpu.data import create_criteo_features as jax_criteo
from recman_tpu.models import XDeepFM as JaxXDeepFM
from recman_tpu.ops import cin_interact as jax_cin_interact
from recman_tpu.ops import embedding as jax_emb
from recman_tpu.training import init_state as jax_init_state
from recman_tpu.training.train_step import (
    TrainState as JaxTrainState,
    make_train_step_stacked as jax_make_train_step_stacked,
    make_train_step_unrolled as jax_make_train_step_unrolled,
    pack_dataset as jax_pack_dataset,
    stack_table_params as jax_stack_table_params,
)
from recman_tpu.training.trainer import batch_indices as jax_batch_indices
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.ops import cin_chain, segment_matmul
from recman_tpu_torch.serving import batch_indices
from recman_tpu_torch.training import (
    STACKED_KEY,
    TrainState,
    create_optimizer,
    gather_batch,
    make_train_step_stacked,
    pack_dataset,
    stack_table_params,
    stack_train_state,
    unpack_batch,
    unstack_table_params,
    unstack_train_state,
)
from recman_tpu_torch.training.train_step import loss_and_grads

NUM_BUCKETS = 1000
HPARAMS = {
    "embedding_size": 16,
    "cin_cross_layer_units": (8, 6),
    "cin_dropout": (1, 1, 1),
    "deep_hidden_units": (32, 32),
    "deep_dropout": (1.0, 1.0, 1.0),
}
N_ROWS, BATCH, STEPS = 512, 64, 4


def _shipped_ctx():
    """The JAX package's shipped TPU path, interpreted on the CPU."""
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(jax_emb.fused_grad(True))
    stack.enter_context(jax_cin_interact.pallas_cin(True))
    stack.enter_context(jax_emb.grad_kernel("segmat"))
    return stack


def _batches():
    idx = batch_indices(N_ROWS, BATCH, shuffle_seed=0)
    return idx[(idx >= 0).all(axis=1)][:STEPS]


@pytest.fixture(scope="module")
def jax_runs():
    """Everything the JAX package computes, once for the module."""
    model = JaxXDeepFM(jax_criteo(num_buckets=NUM_BUCKETS), HPARAMS)
    data = synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=2019)
    packed, layout = jax_pack_dataset(data)
    jdata = {k: jnp.asarray(v) for k, v in packed.items()}
    opt = optax.adam(1e-3)
    idx = jnp.asarray(_batches())
    base = jax_init_state(model, opt, jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in base.params.items()}
    params_s, names = jax_stack_table_params(model, base.params)

    from recman_tpu.training.train_step import gather_batch as jgb, unpack_batch as jub

    batch, weights = jgb(jdata, idx[0])
    batch = jub(batch, layout)

    def loss_fn(params):
        with jax_emb.stacked_tables(names, params[STACKED_KEY]):
            return model.loss(params, batch, training=True, rng=None, weights=weights)

    with _shipped_ctx():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params_s)
        step_s = jax_make_train_step_stacked(model, opt, STEPS, names)
        st = JaxTrainState(params_s, opt.init(params_s), base.step, base.rng)
        _, trace_shipped = step_s(st, jdata, idx, layout)
    with jax_emb.fused_grad(False):
        # the steps donate their state: start again from the same init
        step_f = jax_make_train_step_unrolled(model, opt, STEPS)
        _, trace_f32 = step_f(jax_init_state(model, opt, jax.random.PRNGKey(0)),
                              jdata, idx, layout)
    return {
        "params": np_params,
        "names": names,
        "loss": float(loss),
        "grads": {k: np.asarray(v) for k, v in grads.items()},
        "trace_shipped": np.asarray(trace_shipped),
        "trace_f32": np.asarray(trace_f32),
    }


@pytest.fixture(scope="module")
def port():
    model = XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), HPARAMS)
    data = synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=2019)
    packed, layout = pack_dataset(data)
    tdata = {k: torch.as_tensor(v) for k, v in packed.items()}
    return model, tdata, layout


@pytest.fixture(scope="module")
def port_stacked(jax_runs, port):
    model, tdata, layout = port
    params = params_from_jax(jax_runs["params"], device="cpu")
    params_s, names = stack_table_params(model, params)
    assert names == jax_runs["names"]
    idx = torch.as_tensor(_batches())
    batch, weights = gather_batch(tdata, idx[0])
    batch = unpack_batch(batch, layout)
    loss, grads = loss_and_grads(model, params_s, batch, weights, names=names)
    return params_s, names, loss, grads


def _param_names():
    model = XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), HPARAMS)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    return sorted(stack_table_params(model, params)[0])


def test_stacked_loss_matches_jax_shipped_path(jax_runs, port_stacked):
    loss = float(port_stacked[2])
    assert abs(loss - jax_runs["loss"]) <= 1e-6 * abs(jax_runs["loss"])


@pytest.mark.parametrize("name", _param_names())
def test_stacked_grads_match_jax_shipped_path(jax_runs, port_stacked, name):
    ref = jax_runs["grads"][name]
    got = port_stacked[3][name].numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def _port_trace(jax_runs, port):
    model, tdata, layout = port
    params = params_from_jax(jax_runs["params"], device="cpu")
    params_s, names = stack_table_params(model, params)
    opt = create_optimizer("adam", 1e-3)
    state = TrainState(params_s, opt.init(params_s), 0, None)
    step = make_train_step_stacked(model, opt, STEPS, names)
    state, losses = step(state, tdata, torch.as_tensor(_batches()), layout)
    return state, losses.numpy()


@pytest.fixture(scope="module")
def port_trace(jax_runs, port):
    return _port_trace(jax_runs, port)


def test_stacked_trace_matches_jax_shipped_path(jax_runs, port_trace):
    state, trace = port_trace
    assert state.step == STEPS and trace.shape == (STEPS,)
    assert np.abs(trace - jax_runs["trace_shipped"]).max() <= 1e-5


def test_stacked_trace_matches_jax_f32_path(jax_runs, port_trace):
    trace, ref = port_trace[1], jax_runs["trace_f32"]
    assert np.abs(trace - ref).max() <= 6e-3
    assert abs(trace[-1] - ref[-1]) / max(ref[-1], 1e-9) <= 0.01


def test_stacked_step_uses_no_kernel_launch_on_cpu(jax_runs, port):
    before = (cin_chain.LAUNCHES, cin_chain.BWD_LAUNCHES, segment_matmul.LAUNCHES)
    _port_trace(jax_runs, port)
    assert (cin_chain.LAUNCHES, cin_chain.BWD_LAUNCHES, segment_matmul.LAUNCHES) == before


def test_stacked_and_per_table_steps_agree(jax_runs, port):
    """The stacked step and the per-table step (plain autograd of the
    gathers) train the same trajectory."""
    from recman_tpu_torch.training import make_train_step_unrolled

    model, tdata, layout = port
    opt = create_optimizer("adam", 1e-3)
    params = params_from_jax(jax_runs["params"], device="cpu")
    state = TrainState(params, opt.init(params), 0, None)
    _, losses = make_train_step_unrolled(model, opt, STEPS)(
        state, tdata, torch.as_tensor(_batches()), layout)
    np.testing.assert_allclose(losses.numpy(), jax_runs["trace_shipped"], rtol=0, atol=1e-5)


def test_adam_matches_optax():
    rs = np.random.RandomState(4)
    params = {"a": rs.randn(7, 3).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    jopt = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init(jp)
    topt = create_optimizer("adam", 1e-3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = topt.init(tp)
    from recman_tpu_torch.training import apply_updates

    for g in grads:
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tst = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tst, tp)
        tp = apply_updates(tp, tu)
    assert int(tst.count) == 3 and tst.count.dtype == torch.int32
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(tst.mu[k].numpy(), np.asarray(jst[0].mu[k]), rtol=1e-6)
        np.testing.assert_allclose(tst.nu[k].numpy(), np.asarray(jst[0].nu[k]), rtol=1e-6)


def test_unported_optimizer_raises():
    with pytest.raises(NotImplementedError, match="item 8"):
        create_optimizer("adagrad", 1e-3)


def test_stack_train_state_roundtrip(port):
    model = port[0]
    opt = create_optimizer("adam", 1e-3)
    params = model.init_params(torch.Generator().manual_seed(1), device="cpu")
    state = TrainState(params, opt.init(params), 3, None)
    stacked = stack_train_state(model, state)
    assert STACKED_KEY in stacked.params and STACKED_KEY in stacked.opt_state.mu
    assert stacked.params[STACKED_KEY].shape == (26, NUM_BUCKETS + 1, 16)
    back = unstack_train_state(model, stacked)
    assert back.step == 3 and set(back.params) == set(params)
    for tree_a, tree_b in ((back.params, params), (back.opt_state.mu, state.opt_state.mu),
                           (back.opt_state.nu, state.opt_state.nu)):
        assert set(tree_a) == set(tree_b)
        for k in tree_b:
            assert torch.equal(tree_a[k], tree_b[k])
    assert unstack_train_state(model, state) is state
    assert set(unstack_table_params(model, params)) == set(params)


def test_stackable_matches_jax():
    from recman_tpu.layers.packed import PackedEmbeddingLinear as JaxPacked

    jm = JaxXDeepFM(jax_criteo(num_buckets=50), HPARAMS)
    tm = XDeepFM(create_criteo_features(num_buckets=50), HPARAMS)
    assert isinstance(jm.packed, JaxPacked)
    assert tm.packed.stackable() == jm.packed.stackable()


def test_params_from_jax_carries_the_stacked_leaf(jax_runs):
    model = JaxXDeepFM(jax_criteo(num_buckets=NUM_BUCKETS), HPARAMS)
    params = {k: jnp.asarray(v) for k, v in jax_runs["params"].items()}
    params_s, _ = jax_stack_table_params(model, params)
    got = params_from_jax({k: np.asarray(v) for k, v in params_s.items()}, device="cpu")
    assert got[STACKED_KEY].shape == (26, NUM_BUCKETS + 1, 16)
    for k, v in params_s.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def test_embedding_l2_stacked_gate_matches_jax(jax_runs, port):
    """The stack replaces the per-table L2 only when the context names are
    the layer's owned feats in order (the reference's gate, kept)."""
    from recman_tpu_torch.ops.embedding import stacked_tables

    jm = JaxXDeepFM(jax_criteo(num_buckets=NUM_BUCKETS), HPARAMS)
    tm = port[0]
    jp = {k: jnp.asarray(v) for k, v in jax_runs["params"].items()}
    tp = params_from_jax(jax_runs["params"], device="cpu")
    names = jax_runs["names"]
    jstack = jnp.stack([jp[f"{n}_feat_embed"] for n in names]) * 2.0
    tstack = torch.from_numpy(np.asarray(jstack))
    for ctx_names in (names, names[::-1], names[:3]):
        with jax_emb.stacked_tables(ctx_names, jstack):
            ref = float(jm.embeddings.l2(jp))
        with stacked_tables(ctx_names, tstack):
            got = float(tm.embeddings.l2(tp))
        assert abs(got - ref) <= 1e-6 * abs(ref)


def test_numerics_match_jax():
    from recman_tpu.utils import numerics as jn
    from recman_tpu_torch.utils import numerics as tn

    rs = np.random.RandomState(2)
    y = (rs.rand(50) > 0.5).astype(np.float32)
    p = rs.rand(50).astype(np.float32)
    p[:3] = [0.0, 1.0, 1e-9]  # clipped at 1e-7
    w = (rs.rand(50) > 0.2).astype(np.float32)
    x = rs.randn(6, 4).astype(np.float32)
    T = torch.from_numpy
    np.testing.assert_allclose(float(tn.l2_loss(T(x))), float(jn.l2_loss(x)), rtol=1e-6)
    for wt in (None, w, np.zeros_like(w)):
        for tf, jf in ((tn.binary_cross_entropy, jn.binary_cross_entropy),
                       (tn.mean_squared_error, jn.mean_squared_error)):
            got = float(tf(T(y), T(p), None if wt is None else T(wt)))
            ref = float(jf(y, p, wt))
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_dropout_keep_semantics():
    from recman_tpu_torch.layers import dropout

    x = torch.ones((200, 50))
    g = torch.Generator().manual_seed(0)
    assert dropout(g, x, 1.0, True) is x
    assert dropout(g, x, 0.5, False) is x
    assert dropout(None, x, 0.5, True) is x
    y = dropout(g, x, 0.8, True)
    kept = y != 0
    assert torch.all(y[kept] == 1.0 / 0.8)
    assert abs(kept.float().mean().item() - 0.8) < 0.02


def test_dropout_refuses_a_generator_on_another_device():
    from recman_tpu_torch.layers import dropout

    x = torch.ones((4, 3), device="meta")
    with pytest.raises(ValueError, match="generator"):
        dropout(torch.Generator().manual_seed(0), x, 0.5, True)


def test_init_state_seeds_a_dropout_generator_on_the_device(port):
    from recman_tpu_torch.training import init_state

    model = port[0]
    opt = create_optimizer("adam", 1e-3)
    a, b = (init_state(model, opt, torch.Generator().manual_seed(0), device="cpu")
            for _ in range(2))
    assert a.step == 0 and a.generator.device.type == "cpu"
    assert int(a.opt_state.count) == 0
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert torch.equal(torch.rand(5, generator=a.generator), torch.rand(5, generator=b.generator))


def test_live_cin_dropout_leaves_the_chain_on_cpu(port):
    """CIN in training takes the chain only with every keep past index 0
    at 1; otherwise the CPU runs the batch-major path (CUDA raises, naming
    K4: tests/test_torch_cuda_kernels.py)."""
    from recman_tpu_torch.layers import CIN

    cin = CIN(field_size=5, cross_layer_units=(6, 4), activation="relu",
              dropout_keep=(1, 0.5, 1))
    params = cin.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((32, 5, 4))
    before = cin_chain.LAUNCHES
    assert cin._chain_eligible(False, 32, 4) and not cin._chain_eligible(True, 32, 4)
    out = cin.apply(params, x, training=True, generator=torch.Generator().manual_seed(1))
    assert out.shape == (32, 1) and torch.isfinite(out).all()
    assert cin_chain.LAUNCHES == before


def test_override_is_ignored_in_training(port):
    model, tdata, layout = port
    params = model.init_params(torch.Generator().manual_seed(2), device="cpu")
    params["linear_w"] = 0.3 * torch.randn(params["linear_w"].shape)
    batch, _ = gather_batch(tdata, torch.arange(BATCH))
    batch = unpack_batch(batch, layout)
    override = torch.full_like(params["linear_w"], -5.0)
    train = model.apply(params, batch, training=True, linear_override=override)
    plain = model.apply(params, batch, training=True)
    served = model.apply(params, batch, training=False, linear_override=override)
    assert torch.equal(train, plain) and not torch.allclose(served, plain)


def test_pack_dataset_matches_jax():
    data = synthetic_criteo_arrays(100, num_buckets=NUM_BUCKETS, seed=1)
    data["wide"] = np.arange(300, dtype=np.int64).reshape(100, 3)
    jp, jl = jax_pack_dataset(data)
    tp, tl = pack_dataset(data)
    assert tl == jl and set(tp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
        assert tp[k].dtype == jp[k].dtype
    batch = unpack_batch({k: torch.as_tensor(v) for k, v in tp.items()}, tl)
    for k, v in data.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v).astype(batch[k].numpy().dtype))


@pytest.mark.parametrize("n,bs,seed", [(512, 64, 0), (100, 32, 3), (7, 8, 1)])
def test_shuffled_batch_indices_match_jax(n, bs, seed):
    np.testing.assert_array_equal(batch_indices(n, bs, shuffle_seed=seed),
                                  jax_batch_indices(n, bs, shuffle_seed=seed))


def test_gather_batch_weights_padding():
    data = {"a": torch.arange(10) * 2}
    batch, w = gather_batch(data, torch.tensor([3, -1, 9, -1], dtype=torch.int32))
    assert batch["a"].tolist() == [6, 0, 18, 0]
    assert w.tolist() == [1.0, 0.0, 1.0, 0.0] and w.dtype == torch.float32
