"""The port's optimizer menu and learning-rate schedules
(recman_tpu_torch/training/train_step.py, lr_schedule.py, rowwise_adam.py)
against optax and the JAX package's own schedule functions on the CPU.

Inputs are made with numpy from a seed and handed to both sides. Each
optimizer runs 5 updates on a small param dict (two (50, 4) tables, a
(6, 3) matrix, a (3,) vector) with a float and with a schedule learning
rate. Tolerance, per leaf, of the largest element of the reference: 1e-6
for every update and the final params (the same formulas in float32;
sqrt, rsqrt, a norm or a mean may round one ulp apart), 1e-3 where a
moment is stored in bf16 (adam_bf16m, rowwise_adam: a moment one bf16
step apart moves the next update by that much). Schedules match optax's
at every count from 0 to the end plus 5 to 1e-6 relative (float32; cos
may round one ulp apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from recman_tpu.data import create_criteo_features as jax_criteo_features
from recman_tpu.models import XDeepFM as JaxXDeepFM
from recman_tpu.training import lr_schedule as jax_sched
from recman_tpu.training import train_step as jax_ts
from recman_tpu_torch.data import create_criteo_features
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.training import (
    STACKED_KEY,
    TrainState,
    apply_updates,
    create_optimizer,
    stack_train_state,
    unstack_train_state,
)
from recman_tpu_torch.training import lr_schedule as sched
from recman_tpu_torch.training.rowwise_adam import rowwise_adam, scale_by_rowwise_adam
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

NAMES = ["adam", "adam_bf16m", "adagrad", "gd", "sgd", "momentum", "lamb", "rowwise_adam"]
BF16_MOMENTS = ("adam_bf16m", "rowwise_adam")
STEPS = 5


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "a_feat_embed": (0.1 * rs.randn(50, 4)).astype(np.float32),
        "b_feat_embed": (0.1 * rs.randn(50, 4)).astype(np.float32),
        "w": rs.randn(6, 3).astype(np.float32),
        "v": rs.randn(3).astype(np.float32),
    }


def _grads(params, seed=1):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        g = {k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        for k in ("a_feat_embed", "b_feat_embed"):  # rows of ids not in the batch
            g[k][rs.rand(g[k].shape[0]) < 0.6] = 0.0
        g["w"][0] = 0.0
        out.append(g)
    return out


def _schedules(kind):
    """(port lr, JAX lr): a float, or warmup from 0 then cosine decay."""
    if kind == "float":
        return 1e-2, 1e-2
    return (sched.warmup_schedule(1e-2, 2, STEPS, decay="cosine"),
            jax_sched.warmup_schedule(1e-2, 2, STEPS, decay="cosine"))


def _optimizers(name, kind):
    lr_t, lr_j = _schedules(kind)
    if name == "lamb_partitioned":
        return sched.lamb_partitioned(lr_t), jax_sched.lamb_partitioned(lr_j)
    return create_optimizer(name, lr_t), jax_ts.create_optimizer(name, lr_j)


def _rel(ref, got):
    ref, got = np.asarray(ref, dtype=np.float64), np.asarray(got, dtype=np.float64)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max()
    scale = np.abs(ref).max()
    return err / scale if scale else err


@pytest.mark.parametrize("kind", ["float", "schedule"])
@pytest.mark.parametrize("name", NAMES + ["lamb_partitioned"])
def test_optimizer_matches_optax(name, kind):
    topt, jopt = _optimizers(name, kind)
    params = _params()
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tst, jst = topt.init(tp), jopt.init(jp)
    tol = 1e-3 if name in BF16_MOMENTS else 1e-6
    for i, g in enumerate(_grads(params)):
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tst = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tst, tp)
        tp = apply_updates(tp, tu)
        for k in params:
            assert tu[k].dtype == torch.float32
            assert _rel(ju[k], tu[k]) <= tol, (i, k)
        if kind == "schedule" and i == 0:  # optax reads the schedule before counting
            assert all(not tu[k].any() for k in params)
    for k in params:
        assert _rel(jp[k], tp[k]) <= tol, k


def test_rowwise_adam_state_shapes_and_scale_by_rowwise_adam():
    """Tables keep a (V,) second moment and a bf16 first moment; the rest
    Adam's. ``scale_by_rowwise_adam`` alone is the scaling without -lr."""
    params = _params()
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = rowwise_adam(1e-3).init(tp)
    table = st.inner_states["table"]
    assert table.nu["a_feat_embed"].shape == (50,) and table.mu["a_feat_embed"].dtype == torch.bfloat16
    assert st.inner_states["rest"].mu["w"].shape == (6, 3)
    g = {k: torch.from_numpy(v) for k, v in _grads(params)[0].items()}
    jg = {k: jnp.asarray(v) for k, v in _grads(params)[0].items()}
    from recman_tpu.training.rowwise_adam import scale_by_rowwise_adam as jax_scale

    js = jax_scale()
    ju, _ = js.update(jg, js.init({k: jnp.asarray(v) for k, v in params.items()}))
    ts_ = scale_by_rowwise_adam()
    tu, _ = ts_.update(g, ts_.init(tp))
    for k in params:
        assert _rel(ju[k], tu[k]) <= 1e-3, k


CASES = [  # (schedule function, args, count limit)
    ("linear_schedule", (0.0, 2e-2, 7), 12),
    ("cosine_decay_schedule", (3e-3, 9), 14),
    ("warmup none", (1e-2, 4, None, "none"), 9),
    ("warmup cosine", (1e-2, 4, 20, "cosine"), 25),
    ("warmup linear", (1e-2, 4, 20, "linear"), 25),
    ("warmup zero", (1e-2, 0, 10, "cosine"), 15),
    ("large_batch_schedule", (1e-3, 65536, 8192, 2, 19, "cosine"), 24),
]


def _build(pkg_sched, name, args):
    if name in ("linear_schedule", "cosine_decay_schedule"):
        return getattr(sched if pkg_sched is sched else optax, name)(*args)
    if name.startswith("warmup"):
        return pkg_sched.warmup_schedule(*args)
    return pkg_sched.large_batch_schedule(*args)


@pytest.mark.parametrize("name,args,limit", CASES)
def test_schedule_matches_optax(name, args, limit):
    got, ref = _build(sched, name, args), _build(jax_sched, name, args)
    for count in range(limit + 1):
        r = float(np.float32(ref(jnp.asarray(count, jnp.int32))))
        g = got(count)
        assert isinstance(g, np.float32)
        assert abs(float(g) - r) <= 1e-6 * abs(r), (count, float(g), r)


def test_scaled_learning_rates():
    assert sched.linear_scaled_lr(1e-3, 65536, 8192) == jax_sched.linear_scaled_lr(1e-3, 65536, 8192)
    assert sched.sqrt_scaled_lr(1e-3, 65536, 8192) == jax_sched.sqrt_scaled_lr(1e-3, 65536, 8192)


# -- stacked storage of every optimizer's state --------------------------------

HP = {"embedding_size": 4, "cin_cross_layer_units": (4, 4), "cin_dropout": (1, 1, 1),
      "deep_hidden_units": (8,), "deep_dropout": (1.0, 1.0)}


@pytest.fixture(scope="module")
def small_model():
    return XDeepFM(create_criteo_features(num_buckets=20), HP)


@pytest.mark.parametrize("name", [n for n in NAMES if n != "rowwise_adam"])
def test_stack_train_state_roundtrip(small_model, name):
    """Every param-shaped tree of the state moves to stacked storage and
    back unchanged, whatever the optimizer."""
    opt = create_optimizer(name, sched.warmup_schedule(1e-2, 2, 5))
    params = small_model.init_params(torch.Generator().manual_seed(1), device="cpu")
    state = TrainState(params, opt.init(params), 2, None)
    grads = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(2))
             for k, v in params.items()}
    _, opt_state = opt.update(grads, state.opt_state, params)
    state = state._replace(opt_state=opt_state)
    stacked = stack_train_state(small_model, state)
    assert STACKED_KEY in stacked.params
    flat = jax.tree_util.tree_leaves(stacked.opt_state, is_leaf=lambda x: isinstance(x, dict))
    shaped = [d for d in flat if isinstance(d, dict)]
    assert all(STACKED_KEY in d for d in shaped)
    assert bool(shaped) == (name not in ("gd", "sgd"))  # plain sgd keeps no moments
    back = unstack_train_state(small_model, stacked)
    ref_leaves = jax.tree_util.tree_leaves(state.opt_state)
    got_leaves = jax.tree_util.tree_leaves(back.opt_state)
    assert len(ref_leaves) == len(got_leaves)
    assert all(torch.equal(a, b) for a, b in zip(ref_leaves, got_leaves))
    assert all(torch.equal(back.params[k], params[k]) for k in params)


@pytest.mark.parametrize("name", ["rowwise_adam", "lamb_partitioned"])
def test_partitioned_state_has_no_stacked_form(small_model, name):
    """A partitioned optimizer masks the tables out of one of its states;
    the reference's stack_train_state fails on it (jnp.stack of optax's
    MaskedNode), and so does the port's, with a TypeError naming why."""
    jmodel = JaxXDeepFM(jax_criteo_features(num_buckets=20), HP)
    jopt = (jax_sched.lamb_partitioned(1e-3) if name == "lamb_partitioned"
            else jax_ts.create_optimizer(name, 1e-3))
    with pytest.raises(TypeError):
        jax_ts.stack_train_state(jmodel, jax_ts.init_state(jmodel, jopt, jax.random.PRNGKey(0)))
    opt = sched.lamb_partitioned(1e-3) if name == "lamb_partitioned" else create_optimizer(name, 1e-3)
    params = small_model.init_params(torch.Generator().manual_seed(1), device="cpu")
    with pytest.raises(TypeError, match="masked"):
        stack_train_state(small_model, TrainState(params, opt.init(params), 0, None))
