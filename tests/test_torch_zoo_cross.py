"""The port's cross and product models (recman_tpu_torch) against the JAX
package on the CPU: CrossNetV2, DCN-V2, GDCN, ProductLayer, PNN, DLRM and
BatchNormalization, the registry, ``Trainer.fit`` and a checkpoint.

Inputs: the reference's 16-row synthetic fixture with every feature type
(``test_torch_xdeepfm._schema``) and a small Criteo-shaped set (4 hashed
fields of 50 buckets, 3 dense, 24 rows; ``criteo_schema``). Params are
drawn by JAX, every zero-initialised vector given random values from a
numpy seed, and carried across with ``convert.params_from_jax``; every
dropout keep is 1. Each JAX model's predictions, loss and gradients are
computed once per module (``jax_reference``) and shared by its cases.

Tolerances (those of ``test_torch_zoo.py``):
- initial params from ``JaxKey(2019)``: the names in JAX's order, the
  values within 2 float32 ulps of 1 (2.4e-7) of ``init_params(
  PRNGKey(2019))``'s, ``test_torch_zoo.py``'s bound (the uniform bits are
  JAX's bit for bit; the truncated normal's ``erf_inv`` takes numpy's
  ``log1p``, one ulp from XLA's on some draws);
- eval predictions 1e-5 absolute;
- the training loss 1e-6 relative;
- every gradient 1e-5 of its leaf's max|ref|, on each package's default
  CPU route ("auto") and on the kernels' route (the port's K3/K6 twins
  under ``fused_grad(True), grad_kernel("segmat")``);
- ``Trainer.fit`` on a 1% ML-100K subsample at lr 1e-3: epoch mean loss
  1e-4 relative, valid predictions 1e-4 absolute.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import recman_tpu
import recman_tpu_torch
from recman_tpu import layers as jax_layers
from recman_tpu import models as jax_models
from recman_tpu.ops import embedding as jax_emb
from recman_tpu.serving import Predictor as JaxPredictor
from recman_tpu.training import LogLoss as JaxLogLoss
from recman_tpu.training import Trainer as JaxTrainer
from recman_tpu_torch import layers, models
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.ops import embedding as torch_emb
from recman_tpu_torch.serving import Predictor
from recman_tpu_torch.training import LogLoss, Trainer, create_optimizer, init_state
from recman_tpu_torch.training.train_step import apply_updates, loss_and_grads
from recman_tpu_torch.utils import JaxKey
from tests.test_torch_xdeepfm import _schema, _shared_params
from tests.test_torch_zoo import ml  # noqa: F401  (the 1% ML-100K fixture)
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

PRED_TOL = 1e-5
LOSS_REL = 1e-6
GRAD_TOL = 1e-5
FIT_LOSS_REL, FIT_PRED_ABS = 1e-4, 1e-4
ULPS = 2.4e-7
ROUTES = ("auto", "kernels")

# every dropout keep at 1, so that both packages run the same formulas
KEEPS = {
    "dcn_v2": {}, "gdcn": {}, "dlrm": {}, "autoint": {}, "masknet": {}, "final_mlp": {},
    "pnn": {"deep_dropout": (1.0, 1.0, 1.0)},
    "fibinet": {"deep_dropout": (1.0, 1.0, 1.0)},
}


# -- schemas -------------------------------------------------------------------

def criteo_frame(rows=24, seed=5):
    rs = np.random.RandomState(seed)
    data = {f"C{j}": rs.choice([f"v{i}" for i in range(12)] + [""], size=rows) for j in range(1, 5)}
    data.update({f"I{j}": rs.lognormal(0.0, 1.0, size=rows) for j in range(1, 4)})
    data["LABEL"] = rs.randint(0, 2, size=rows)
    return pd.DataFrame(data)


def criteo_schema(pkg, df):
    """4 hashed fields of 50 buckets and 3 dense, Criteo's feature types at
    a small size."""
    fs = pkg.FeatureSet()
    for j in range(1, 5):
        fs[f"C{j}"] = pkg.HashedSparseFeat(f"C{j}", num_buckets=50)
    for j in range(1, 4):
        fs[f"I{j}"] = pkg.DenseFeat(f"I{j}")
    fs.initialize(df)
    return fs


def no_dense_schema(pkg, df):
    """The synthetic schema without its dense feature."""
    fs = _schema(pkg, df)
    del fs["TIMESTAMP"]
    return fs


SCHEMAS = {"synthetic": _schema, "criteo": criteo_schema, "no-dense": no_dense_schema}


def frame(schema, synthetic_df):
    """The rows of a schema: the conftest's 16-row ``synthetic_df`` (every
    feature type) or the Criteo-shaped frame."""
    return criteo_frame() if schema == "criteo" else synthetic_df


# -- the shared JAX reference ---------------------------------------------------

def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


_REFERENCE = {}


def jax_reference(name, hparams, schema, synthetic_df):
    """The JAX model's eval predictions, training loss and gradients on the
    schema's frame from ``_shared_params``, computed once per module (the
    frames are the same in every test); and the port's model on the same
    schema and hparams."""
    key = (name, repr(sorted((hparams or {}).items())), schema)
    if key not in _REFERENCE:
        build, df = SCHEMAS[schema], frame(schema, synthetic_df)
        hp = {**KEEPS[name], **(hparams or {})}
        jm = jax_models.MODEL_REGISTRY[name](build(recman_tpu, df), hp)
        tm = models.model_class(name)(build(recman_tpu_torch, df), hp)
        np_params = _shared_params(jm)
        batch = tm.feat_dict.transform(df, y=df["LABEL"].values)
        # jitted, so that a warm compilation cache serves the module's graphs
        preds = np.asarray(jax.jit(lambda p, b: jm.apply(p, b, training=False))(
            _jnp(np_params), _jnp(batch)))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b, training=True, rng=None)))(_jnp(np_params), _jnp(batch))
        _REFERENCE[key] = dict(jm=jm, tm=tm, np_params=np_params, batch=batch, preds=preds,
                               loss=float(loss), grads={k: np.asarray(v) for k, v in grads.items()})
    return _REFERENCE[key]


def jax_l2(layer, np_params):
    """A JAX layer's or model's L2 of numpy params."""
    return float(layer.l2(_jnp(np_params)))


def assert_grads(ref, got, what, noise=()):
    """Every leaf within GRAD_TOL of its max|ref|. A leaf in ``noise`` has a
    gradient that is cancellation noise on both sides (under a saturated
    softmax): it is held to GRAD_TOL of the largest gradient of any leaf
    instead, as ``test_torch_seq.py`` holds its zero gradients."""
    assert set(got) == set(ref)
    largest = max(float(np.abs(v).max()) for v in ref.values()) or 1.0
    for k in ref:
        scale = largest if k in noise else (float(np.abs(ref[k]).max()) or 1.0)
        err = float(np.abs(got[k].numpy() - ref[k]).max())
        assert err <= GRAD_TOL * scale, f"{what} {k}: {err} > {GRAD_TOL} * {scale}"


def check_model(name, hparams, schema, route, synthetic_df, noise=()):
    """Params (names, order, shapes), eval predictions, the training loss
    and every gradient of the port against JAX on one backward route."""
    r = jax_reference(name, hparams, schema, synthetic_df)
    tm, np_params = r["tm"], r["np_params"]
    own = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert [(k, tuple(v.shape)) for k, v in own.items()] == \
        [(k, v.shape) for k, v in np_params.items()]
    params = params_from_jax(np_params, device="cpu")
    with torch.inference_mode():
        got = tm.apply(params, _tt(r["batch"])).numpy()
    assert got.shape == r["preds"].shape
    assert np.abs(got - r["preds"]).max() <= PRED_TOL
    with torch_emb.fused_grad(route == "kernels"), \
            torch_emb.grad_kernel("segmat" if route == "kernels" else "auto"):
        loss, grads = loss_and_grads(tm, params, _tt(r["batch"]))
    assert abs(loss.item() - r["loss"]) <= LOSS_REL * abs(r["loss"])
    assert_grads(r["grads"], grads, f"{name} {hparams} [{schema}, {route}]", noise)
    return r, grads


def check_init_from_jax_key(name, schema, synthetic_df):
    """``init_params(JaxKey(2019))`` is JAX's ``init_params(PRNGKey(2019))``:
    the same names in the same order, the values within ``ULPS``."""
    build, df = SCHEMAS[schema], frame(schema, synthetic_df)
    ref = jax_models.MODEL_REGISTRY[name](build(recman_tpu, df), KEEPS[name]).init_params(
        jax.random.PRNGKey(2019))
    got = models.model_class(name)(build(recman_tpu_torch, df), KEEPS[name]).init_params(
        JaxKey(2019), device="cpu")
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        assert tuple(got[k].shape) == v.shape
        assert np.abs(got[k].numpy() - np.asarray(v)).max() <= ULPS, k


# -- the models ------------------------------------------------------------------

MODELS = ("dcn_v2", "gdcn", "pnn", "dlrm")


@pytest.mark.parametrize("schema", ["synthetic", "criteo"])
@pytest.mark.parametrize("name", MODELS)
def test_init_from_jax_key_matches_jax(name, schema, synthetic_df):
    check_init_from_jax_key(name, schema, synthetic_df)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("schema", ["synthetic", "criteo"])
@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(name, schema, route, synthetic_df):
    """Each of the four at its defaults: DCN-V2 parallel and full rank, GDCN
    parallel, PNN inner, DLRM with its bottom MLP."""
    check_model(name, None, schema, route, synthetic_df)


CROSS_VARIANTS = {
    "stacked-full": {"structure": "stacked"},
    "stacked-rank4": {"structure": "stacked", "cross_rank": 4},
    "parallel-rank4": {"cross_rank": 4},
    "stacked-rank4-experts3": {"structure": "stacked", "cross_rank": 4, "cross_num_experts": 3},
    "parallel-rank4-experts3": {"cross_rank": 4, "cross_num_experts": 3},
    "stacked-no-linear": {"structure": "stacked", "use_linear": False},
    "parallel-no-linear": {"use_linear": False},
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("variant", list(CROSS_VARIANTS))
def test_dcn_v2_variant_matches_jax(variant, route, synthetic_df):
    hp = CROSS_VARIANTS[variant]
    r, _ = check_model("dcn_v2", hp, "synthetic", route, synthetic_df)
    assert hasattr(r["tm"], "packed") == hp.get("use_linear", True)


@pytest.mark.parametrize("route", ROUTES)
def test_gdcn_stacked_matches_jax(route, synthetic_df):
    r, _ = check_model("gdcn", {"structure": "stacked"}, "criteo", route, synthetic_df)
    assert r["tm"].cross.gated and "cross_v2_wg_2" in r["np_params"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ["outer", "both"])
def test_pnn_variant_matches_jax(kind, route, synthetic_df):
    r, _ = check_model("pnn", {"product_type": kind}, "synthetic", route, synthetic_df)
    f, k = r["tm"].embeddings.field_size, 8
    assert r["tm"].product.output_dim == {"outer": k * k, "both": f * (f - 1) // 2 + k * k}[kind]


@pytest.mark.parametrize("route", ROUTES)
def test_dlrm_without_dense_features_matches_jax(route, synthetic_df):
    """No dense feature: no bottom MLP, the top MLP reads the pairs alone."""
    r, _ = check_model("dlrm", None, "no-dense", route, synthetic_df)
    tm = r["tm"]
    assert tm.n_dense == 0 and tm.bot_units == () and not any("dlrm_bot" in k for k in r["np_params"])
    f = tm.embeddings.field_size
    assert tm.num_fields == f and tm.top.input_dim == f * (f - 1) // 2


def test_dcn_v2_stacked_head_gets_no_gradient_and_adam_leaves_it(synthetic_df):
    """Stacked, the cross head is unused: its gradient is 0 in JAX and None
    from autograd (``loss_and_grads`` gives zeros), its L2 and the layer
    biases' are not in the loss, and an Adam step leaves it as it was."""
    r = jax_reference("dcn_v2", {"structure": "stacked"}, "synthetic", synthetic_df)
    tm, np_params = r["tm"], r["np_params"]
    params = params_from_jax(np_params, device="cpu")
    for k in ("cross_v2_w", "cross_v2_w0"):
        assert not r["grads"][k].any()
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = tm.loss(live, _tt(r["batch"]))
    raw = torch.autograd.grad(loss, [live["cross_v2_w"], live["cross_v2_w0"],
                                     live["cross_v2_w_0"]], allow_unused=True)
    assert raw[0] is None and raw[1] is None and raw[2] is not None
    _, grads = loss_and_grads(tm, params, _tt(r["batch"]))
    assert not grads["cross_v2_w"].any() and not grads["cross_v2_w0"].any()
    # the L2: the layers' matrices only, as JAX's
    hp = {"structure": "stacked", "cross_layer_l2_reg": 0.3}
    jm = jax_models.DCNv2(_schema(recman_tpu, synthetic_df), hp)
    tm2 = models.DCNv2(_schema(recman_tpu_torch, synthetic_df), hp)
    ref_l2 = jax_l2(jm, np_params)
    assert abs(float(tm2.l2(params)) - ref_l2) <= 1e-6 * ref_l2
    moved = dict(params, cross_v2_w=params["cross_v2_w"] * 7, cross_v2_b_0=params["cross_v2_b_0"] + 1)
    assert float(tm2.l2(moved)) == float(tm2.l2(params))
    # one Adam step in each package
    import optax

    opt = create_optimizer("adam", 1e-3)
    updates, _ = opt.update(grads, opt.init(params), params)
    stepped = apply_updates(params, updates)
    jopt = optax.adam(1e-3)
    jup, _ = jopt.update(_jnp(r["grads"]), jopt.init(_jnp(np_params)), _jnp(np_params))
    jstepped = optax.apply_updates(_jnp(np_params), jup)
    for k in ("cross_v2_w", "cross_v2_w0"):
        assert torch.equal(stepped[k], params[k])
        np.testing.assert_array_equal(np.asarray(jstepped[k]), np_params[k])
    assert not torch.equal(stepped["cross_v2_w_0"], params["cross_v2_w_0"])


# -- the layers ------------------------------------------------------------------

def layer_grads_match(jfn, tfn, np_args):
    """Values and the gradients of sum(out * cotangent) of both layers (an
    input the output does not use: zeros in JAX, None from autograd)."""
    ref, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in np_args])
    ct = np.random.RandomState(9).randn(*ref.shape).astype(np.float32)
    ref_g = vjp(jnp.asarray(ct))
    args = [torch.tensor(a).requires_grad_(True) for a in np_args]
    out = tfn(*args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=PRED_TOL)
    got_g = torch.autograd.grad(out, args, torch.as_tensor(ct), allow_unused=True)
    for a, r, g in zip(args, ref_g, got_g):
        r, g = np.asarray(r), (torch.zeros_like(a) if g is None else g).numpy()
        assert np.abs(g - r).max() <= GRAD_TOL * (np.abs(r).max() or 1.0)


def check_layer(jl, tl, key, inputs, call, randomize=()):
    """A layer's ``init`` from ``JaxKey(key)`` within ``ULPS`` of JAX's, then its
    output and every input's and param's gradient, with the zero-initialised
    params in ``randomize`` made random."""
    np_params = {k: np.asarray(v) for k, v in jl.init(jax.random.PRNGKey(key)).items()}
    drawn = tl.init(JaxKey(key), device="cpu")
    assert list(drawn) == list(np_params)
    for k in np_params:
        assert tuple(drawn[k].shape) == np_params[k].shape
        assert np.abs(drawn[k].numpy() - np_params[k]).max() <= ULPS, k
    rs = np.random.RandomState(key)
    for k in randomize:
        np_params[k] = (0.3 * rs.randn(*np_params[k].shape)).astype(np.float32)
    names = list(np_params)
    layer_grads_match(lambda *a: call(jl, dict(zip(names, a[len(inputs):])), *a[:len(inputs)]),
                      lambda *a: call(tl, dict(zip(names, a[len(inputs):])), *a[:len(inputs)]),
                      list(inputs) + [np_params[k] for k in names])
    return np_params


CROSS_LAYERS = {
    "full": {}, "gated": {"gated": True}, "rank3": {"rank": 3},
    "rank3-experts4": {"rank": 3, "num_experts": 4},
}


@pytest.mark.parametrize("variant", list(CROSS_LAYERS))
def test_cross_net_v2_matches_jax(variant):
    d, n, kw = 7, 3, dict(CROSS_LAYERS[variant], l2_reg=0.2)
    jl, tl = jax_layers.CrossNetV2(d, n, **kw), layers.CrossNetV2(d, n, **kw)
    assert tl._layer_param_names(1) == jl._layer_param_names(1)
    x = np.random.RandomState(6).randn(5, d).astype(np.float32)
    np_params = check_layer(jl, tl, 5, [x], lambda l, p, a: l.apply(p, a),
                            randomize=[f"cross_v2_b_{i}" for i in range(n)] + ["cross_v2_w0"])
    check_layer(jl, tl, 5, [x], lambda l, p, a: l.features(p, a))
    assert abs(float(tl.l2(_tt(np_params))) - jax_l2(jl, np_params)) <= 1e-6
    with pytest.raises(AssertionError, match="defined on full-rank"):
        layers.CrossNetV2(d, n, rank=3, gated=True)
    with pytest.raises(AssertionError, match="requires low-rank experts"):
        layers.CrossNetV2(d, n, num_experts=2)


@pytest.mark.parametrize("kind", ["inner", "outer", "both"])
def test_product_layer_matches_jax(kind):
    f, k = 5, 4
    jl, tl = jax_layers.ProductLayer(f, k, kind), layers.ProductLayer(f, k, kind)
    assert tl.output_dim == jl.output_dim and tl.init() == {}
    e = np.random.RandomState(7).randn(6, f, k).astype(np.float32)
    layer_grads_match(lambda a: jl.apply({}, a), lambda a: tl.apply({}, a), [e])
    if kind == "inner":  # the row-major pair order: (0, 1), (0, 2), ..., (3, 4)
        got = tl.apply({}, torch.as_tensor(e)).numpy()
        np.testing.assert_allclose(got[:, 1], (e[:, 0] * e[:, 2]).sum(-1), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[:, 4], (e[:, 1] * e[:, 2]).sum(-1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("training", [True, False], ids=["training", "eval"])
def test_batch_normalization_matches_jax(training):
    """Training: the batch's population moments and the EMA at 0.99; eval:
    the state's moments, the state returned as it is."""
    units = 6
    jb, tb = jax_layers.BatchNormalization(units, prefix="bn1_"), \
        layers.BatchNormalization(units, prefix="bn1_")
    assert {k: np.asarray(v).tolist() for k, v in jb.init().items()} == \
        {k: v.tolist() for k, v in tb.init(device="cpu").items()}
    assert {k: np.asarray(v).tolist() for k, v in jb.init_state().items()} == \
        {k: v.tolist() for k, v in tb.init_state(device="cpu").items()}
    rs = np.random.RandomState(3)
    x = (2.0 * rs.randn(9, units) + 1.0).astype(np.float32)
    params = {"bn1_scale": rs.rand(units).astype(np.float32) + 0.5,
              "bn1_beta": rs.randn(units).astype(np.float32)}
    state = {"bn1_bn_mean": rs.randn(units).astype(np.float32),
             "bn1_bn_var": rs.rand(units).astype(np.float32) + 0.1}
    ref_out, ref_state = jb.apply(_jnp(params), _jnp(state), jnp.asarray(x), training=training)
    got_out, got_state = tb.apply(_tt(params), _tt(state), torch.as_tensor(x), training=training)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out), rtol=0, atol=PRED_TOL)
    for k in state:
        np.testing.assert_allclose(got_state[k].numpy(), np.asarray(ref_state[k]), rtol=1e-6,
                                   atol=1e-7)
    if training:  # ddof 0, as jnp.var: torch.var's default would differ
        var = x.var(axis=0)
        np.testing.assert_allclose(got_state["bn1_bn_var"].numpy(),
                                   0.99 * state["bn1_bn_var"] + 0.01 * var, rtol=1e-5)
    else:
        assert all(np.array_equal(got_state[k].numpy(), state[k]) for k in state)
    # the gradient through the batch moments
    layer_grads_match(lambda a, s, b: jb.apply({"bn1_scale": s, "bn1_beta": b}, _jnp(state), a,
                                               training=training)[0],
                      lambda a, s, b: tb.apply({"bn1_scale": s, "bn1_beta": b}, _tt(state), a,
                                               training=training)[0],
                      [x, params["bn1_scale"], params["bn1_beta"]])


# -- the registry, the Trainer, checkpoints --------------------------------------

def test_registry_and_exports_match_jax():
    assert set(models.MODEL_REGISTRY) == set(jax_models.MODEL_REGISTRY)
    assert len(models.MODEL_REGISTRY) == 19
    for name, cls in jax_models.MODEL_REGISTRY.items():
        assert models.model_class(name).__name__ == cls.__name__
    assert set(jax_models.__all__) <= set(models.__all__)
    assert set(jax_layers.__all__) <= set(layers.__all__)
    assert all(hasattr(layers, n) for n in layers.__all__)
    assert layers.SparseLinearLayer is layers.LinearLayer
    with pytest.raises(KeyError):
        models.model_class("no_such_model")


@pytest.mark.parametrize("name", ["dcn_v2", "dlrm"])
def test_fit_matches_jax_trainer(name, ml):  # noqa: F811
    """One epoch on the kernels' route (the JAX Pallas kernels interpreted,
    the port's K6 twins), from the same seed-2019 params; ML-100K's two
    dense features run DLRM's bottom MLP."""
    hp = {**KEEPS[name], "learning_rate": 1e-3}
    jfs, xtr, ytr, xva = ml["jax"]
    jt = JaxTrainer(jax_models.MODEL_REGISTRY[name](jfs, hp), hp, metrics=(JaxLogLoss(),),
                    epoch=1, batch_size=128, random_seed=2019)
    with jax_emb.fused_grad(True), jax_emb.grad_kernel("segmat"):
        jt.fit(xtr, ytr, random_seed_for_mini_batch=False)
        ref_preds = jt.predict(xva)
    tfs, xtr, ytr, xva = ml["port"]
    tt = Trainer(models.model_class(name)(tfs, hp), hp, metrics=(LogLoss(),), epoch=1,
                 batch_size=128, device="cpu")
    tt.state = init_state(tt.model, tt.optimizer, JaxKey(2019), device="cpu")
    if name == "dlrm":
        assert tt.model.n_dense == 2 and "dlrm_bot_1_weights" in tt.state.params
    with torch_emb.fused_grad(True), torch_emb.grad_kernel("segmat"):
        tt.fit(xtr, ytr, random_seed_for_mini_batch=False)
        preds = tt.predict(xva)
    assert abs(tt.last_mean_loss - jt.last_mean_loss) <= FIT_LOSS_REL * abs(jt.last_mean_loss)
    assert np.abs(preds - ref_preds).max() <= FIT_PRED_ABS


def test_predictor_from_checkpoint_matches_jax(tmp_path):
    """A port-saved DLRM checkpoint on the Criteo-shaped set serves JAX's
    predictions for the same params, and the trainer's own."""
    hp = {"learning_rate": 0.01}
    r = jax_reference("dlrm", None, "criteo", None)
    df = criteo_frame()
    tt = Trainer(models.DLRM(criteo_schema(recman_tpu_torch, df), hp), hp, batch_size=8,
                 device="cpu")
    tt.state = tt.state._replace(params=params_from_jax(r["np_params"], device="cpu"))
    tt.save(tmp_path)
    tp = Predictor.from_checkpoint(tmp_path, "dlrm", hparams=hp, batch_size=8, device="cpu")
    assert isinstance(tp.model, models.DLRM) and tp.device.type == "cpu"
    ref = JaxPredictor(r["jm"], _jnp(r["np_params"]), batch_size=8).predict(df)
    np.testing.assert_allclose(tp.predict(df), ref, rtol=0, atol=PRED_TOL)
    np.testing.assert_array_equal(tp.predict(df), tt.predict(df))
