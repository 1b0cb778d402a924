"""The port's FM family and DCN (recman_tpu_torch) against the JAX package
on the CPU: FM, DeepFM, DCN, FwFM, Wide&Deep, NFM and AFM, their layers,
``examples.model_zoo_ml`` and the reference's initial params drawn
without JAX (``utils.JaxKey``).

Inputs are the reference's 16-row synthetic fixture with every feature
type (``_schema``); params are drawn by JAX, every zero-initialised
vector given random values from a numpy seed, and carried across with
``convert.params_from_jax``; every dropout keep is 1.

Tolerances:
- eval predictions 1e-5 absolute (``test_torch_xdeepfm.py``'s bound for
  the same forward);
- the training loss 1e-6 relative;
- every gradient 1e-5 of its leaf's max|ref|, on each package's default
  CPU route and on the kernels' route (the port's K3/K6 twins under
  ``fused_grad(True), grad_kernel("segmat")``);
- ``Trainer.fit`` on a 1% ML-100K subsample at lr 1e-3:
  ``test_torch_trainer.py``'s bounds (epoch mean loss 1e-4 relative,
  valid predictions 1e-4 absolute);
- ``JaxKey`` draws: bits and uniforms bit for bit, truncated normals and
  whole models' initial params within 2 float32 ulps of 1 (2.4e-7).
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
from recman_tpu import utils as jax_utils
from recman_tpu.data import create_ml_features as jax_ml_features
from recman_tpu.data import get_ml_dataset as jax_ml_dataset
from recman_tpu.ops import embedding as jax_emb
from recman_tpu.serving import Predictor as JaxPredictor
from recman_tpu.training import LogLoss as JaxLogLoss
from recman_tpu.training import Trainer as JaxTrainer
from recman_tpu_torch import layers, models, utils
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.data import concat_rows, create_ml_features, get_ml_dataset
from recman_tpu_torch.examples.model_zoo_ml import run_model
from recman_tpu_torch.ops import embedding as torch_emb
from recman_tpu_torch.serving import Predictor
from recman_tpu_torch.training import LogLoss, Trainer, init_state
from recman_tpu_torch.training.train_step import loss_and_grads
from recman_tpu_torch.utils.jax_random import JaxKey, truncated_normal, uniform
from tests.test_torch_xdeepfm import _schema, _shared_params
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

PRED_TOL = 1e-5
LOSS_REL = 1e-6
GRAD_TOL = 1e-5
ULPS = 2.4e-7
FIT_LOSS_REL, FIT_PRED_ABS = 1e-4, 1e-4

ZOO = ("fm", "deepfm", "dcn", "fwfm", "wide_deep", "nfm", "afm")
# every dropout keep at 1, so both packages run the same formulas
KEEPS = {
    "fm": {},
    "deepfm": {"deep_dropout": (1.0, 1.0, 1.0)},
    "dcn": {"deep_dropout": (1.0, 1.0, 1.0)},
    "fwfm": {},
    "wide_deep": {"deep_dropout": (1.0, 1.0, 1.0)},
    "nfm": {"deep_dropout": (1.0, 1.0, 1.0)},
    "afm": {},
}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _pair(name, df, hparams=None):
    """The JAX model and the port's on the same schema and hparams, and the
    JAX params with every zero-initialised vector made random."""
    hp = {**KEEPS[name], **(hparams or {})}
    jm = jax_models.MODEL_REGISTRY[name](_schema(recman_tpu, df), hp)
    tm = models.model_class(name)(_schema(recman_tpu_torch, df), hp)
    return jm, tm, _shared_params(jm)


def _jax_loss_grads(jm, np_params, batch):
    fn = lambda p: jm.loss(p, _jnp(batch), training=True, rng=None)  # noqa: E731
    loss, grads = jax.value_and_grad(fn)(_jnp(np_params))
    return float(loss), _np(grads)


def _assert_grads(ref, got, what):
    assert set(got) == set(ref)
    for k in ref:
        scale = float(np.abs(ref[k]).max()) or 1.0
        err = float(np.abs(got[k].numpy() - ref[k]).max())
        assert err <= GRAD_TOL * scale, f"{what} {k}: {err} > {GRAD_TOL} * {scale}"


@pytest.mark.parametrize("name", ZOO)
def test_model_matches_jax(name, synthetic_df):
    """Params (names, shapes, dtypes), eval predictions, the training loss
    and every gradient, on both routes of the lookups' backward."""
    jm, tm, np_params = _pair(name, synthetic_df)
    own = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (v.shape, torch.float32) for k, v in np_params.items()}
    assert all(v.dtype == np.float32 for v in np_params.values())
    params = params_from_jax(np_params, device="cpu")
    assert list(params) == list(np_params)
    assert all(params[k].dtype == torch.float32 and tuple(params[k].shape) == v.shape
               for k, v in np_params.items())

    batch = tm.feat_dict.transform(synthetic_df, y=synthetic_df["LABEL"].values)
    ref = np.asarray(jm.apply(_jnp(np_params), _jnp(batch), training=False))
    with torch.inference_mode():
        got = tm.apply(params, _tt(batch)).numpy()
    assert got.shape == (16,)
    assert np.abs(ref - got).max() <= PRED_TOL

    ref_loss, ref_grads = _jax_loss_grads(jm, np_params, batch)
    for route in ("default", "kernels"):
        fused = torch_emb.fused_grad(route == "kernels")
        with fused, torch_emb.grad_kernel("segmat" if route == "kernels" else "auto"):
            loss, grads = loss_and_grads(tm, params, _tt(batch))
        assert abs(loss.item() - ref_loss) <= LOSS_REL * abs(ref_loss)
        _assert_grads(ref_grads, grads, f"{name} [{route}]")


@pytest.mark.parametrize("name,hparams", [
    ("dcn", {"use_linear": False}),
    ("deepfm", {"use_fm": False}),
    ("deepfm", {"use_deep": False}),
], ids=["dcn-no-linear", "deepfm-no-fm", "deepfm-no-deep"])
def test_variant_matches_jax(name, hparams, synthetic_df):
    jm, tm, np_params = _pair(name, synthetic_df, hparams)
    assert set(tm.init_params(torch.Generator(), device="cpu")) == set(np_params)
    if name == "dcn":
        assert not hasattr(tm, "packed") and "linear_w" not in np_params
    batch = tm.feat_dict.transform(synthetic_df, y=synthetic_df["LABEL"].values)
    params = params_from_jax(np_params, device="cpu")
    ref = np.asarray(jm.apply(_jnp(np_params), _jnp(batch), training=False))
    got = tm.apply(params, _tt(batch)).detach().numpy()
    assert np.abs(ref - got).max() <= PRED_TOL
    ref_loss, ref_grads = _jax_loss_grads(jm, np_params, batch)
    loss, grads = loss_and_grads(tm, params, _tt(batch))
    assert abs(loss.item() - ref_loss) <= LOSS_REL * abs(ref_loss)
    _assert_grads(ref_grads, grads, name)


@pytest.mark.parametrize("name", ["fm", "dcn", "afm"])
def test_linear_override_at_inference_matches_jax(name, synthetic_df):
    jm, tm, np_params = _pair(name, synthetic_df)
    for model in (jm, tm):
        model.feat_dict["CATEGORY"].set_weights({"Outdoor": -5.0})
    ov = jm.linear.override_vector()
    np.testing.assert_array_equal(ov, tm.linear.override_vector())
    batch = tm.feat_dict.transform(synthetic_df)
    params = params_from_jax(np_params, device="cpu")
    ref = np.asarray(jm.apply(_jnp(np_params), _jnp(batch), training=False,
                              linear_override=jnp.asarray(ov)))
    got = tm.apply(params, _tt(batch), linear_override=torch.as_tensor(ov)).numpy()
    assert np.abs(ref - got).max() <= PRED_TOL
    base = tm.apply(params, _tt(batch)).numpy()
    outdoor = (synthetic_df["CATEGORY"] == "Outdoor").values
    assert (got[outdoor] < base[outdoor]).all()
    np.testing.assert_array_equal(got[~outdoor], base[~outdoor])
    # never in training
    trained = tm.apply(params, _tt(batch), training=True, linear_override=torch.as_tensor(ov))
    np.testing.assert_array_equal(trained.detach().numpy(), base)


# -- layers ------------------------------------------------------------------

def _embeds(seed, b=6, f=5, k=4):
    return np.random.RandomState(seed).randn(b, f, k).astype(np.float32)


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no-bias"])
def test_embedding_layer_apply_matches_jax(use_bias, synthetic_df):
    jfs, tfs = _schema(recman_tpu, synthetic_df), _schema(recman_tpu_torch, synthetic_df)
    jl = jax_layers.EmbeddingLayer(jfs, 4, use_bias=use_bias)
    tl = layers.EmbeddingLayer(tfs, 4, use_bias=use_bias)
    np_params = _np(jl.init(jax.random.PRNGKey(3)))
    rs = np.random.RandomState(3)
    np_params = {k: (0.3 * rs.randn(*v.shape)).astype(np.float32) if not v.any() else v
                 for k, v in np_params.items()}
    batch = tfs.transform(synthetic_df)
    ref_e, ref_b = jl.apply(_jnp(np_params), _jnp(batch))
    got_e, got_b = tl.apply(_tt(np_params), _tt(batch))
    assert got_e.shape == (16, tl.field_size, 4)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(ref_e), rtol=0, atol=PRED_TOL)
    if use_bias:
        np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), rtol=0, atol=PRED_TOL)
    else:
        assert got_b is None and ref_b is None
    ref_d = jl.apply_dict(_jnp(np_params), _jnp(batch))
    got_d = tl.apply_dict(_tt(np_params), _tt(batch))
    assert list(got_d) == list(ref_d)
    for k in ref_d:
        np.testing.assert_allclose(got_d[k].numpy(), np.asarray(ref_d[k]), rtol=0, atol=PRED_TOL)
    # the concat along the field axis is the dict's values in the feats' order
    torch.testing.assert_close(got_e, torch.cat(list(got_d.values()), dim=1), rtol=0, atol=0)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_linear_layer_apply_matches_jax(training, synthetic_df):
    """Dense terms, multi-val ids (OOV 0 excluded), sparse-value scaling and
    the override (applied only when not training)."""
    jfs, tfs = _schema(recman_tpu, synthetic_df), _schema(recman_tpu_torch, synthetic_df)
    jl = jax_layers.LinearLayer(jfs.linear_features(()))
    tl = layers.LinearLayer(tfs.linear_features(()))
    assert tl.offsets == jl.offsets and tl.total_size == jl.total_size
    rs = np.random.RandomState(4)
    np_params = {"linear_w": rs.randn(jl.total_size).astype(np.float32),
                 "linear_w0": rs.randn(1).astype(np.float32)}
    for fs in (jfs, tfs):
        fs["HISTORICAL_CATEGORIES"].set_weights({"a": 2.0, "c": -1.5})
        fs["CATEGORY"].set_weights({"Rest": 3.0})
    ov = tl.override_vector()
    df = synthetic_df.copy()  # unknown values: the OOV id 0
    df.at[0, "HISTORICAL_CATEGORIES"] = "a|zz|b"
    df.at[1, "MULTI_VAL_1"] = ["zz", "b"]
    df.at[2, "CATEGORY"] = "Gym"
    batch = tfs.transform(df)
    assert (batch["HISTORICAL_CATEGORIES"][0] == 0).any() and (batch["MULTI_VAL_1"][1] == 0).any()
    ref = np.asarray(jl.apply(_jnp(np_params), _jnp(batch), training=training,
                              override=jnp.asarray(ov)))
    got = tl.apply(_tt(np_params), _tt(batch), training=training,
                   override=torch.as_tensor(ov)).numpy()
    assert got.shape == (16, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=PRED_TOL)
    plain = tl.apply(_tt(np_params), _tt(batch), training=training).numpy()
    assert np.array_equal(plain, got) == training


def _layer_grads_match(jfn, tfn, np_args):
    """Values and the gradients of sum(out * cotangent) of both layers."""
    ref, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in np_args])
    ct = np.random.RandomState(9).randn(*ref.shape).astype(np.float32)
    ref_g = vjp(jnp.asarray(ct))
    args = [torch.tensor(a).requires_grad_(True) for a in np_args]
    out = tfn(*args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=PRED_TOL)
    got_g = torch.autograd.grad(out, args, torch.as_tensor(ct))
    for r, g in zip(ref_g, got_g):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * (np.abs(r).max() or 1.0)


def test_crossnet_matches_jax():
    d, n = 7, 3
    jc, tc = jax_layers.CrossNet(d, n, l2_reg=0.1), layers.CrossNet(d, n, l2_reg=0.1)
    np_params = _np(jc.init(jax.random.PRNGKey(5)))
    # the reference's draw: cross_w_{i} at (d, 1)'s fans, stored (d,)
    drawn = tc.init(JaxKey(5), device="cpu")
    assert {k: tuple(v.shape) for k, v in drawn.items()} == \
        {k: v.shape for k, v in np_params.items()}
    assert drawn["cross_w_0"].shape == (d,) and drawn["cross_w"].shape == (d, 1)
    for k in np_params:
        assert np.abs(drawn[k].numpy() - np_params[k]).max() <= ULPS
    np_params["cross_b_1"] = np.linspace(-1, 1, d).astype(np.float32)
    names = list(np_params)
    x = np.random.RandomState(6).randn(5, d).astype(np.float32)

    def jfn(x, *p):
        return jc.apply(dict(zip(names, p)), x)

    def tfn(x, *p):
        return tc.apply(dict(zip(names, p)), x)

    _layer_grads_match(jfn, tfn, [x] + [np_params[k] for k in names])
    assert abs(float(tc.l2(_tt(np_params))) - float(jc.l2(_jnp(np_params)))) <= 1e-7
    # the L2 covers the weights, no bias
    no_bias = dict(np_params, **{f"cross_b_{i}": np.zeros(d, np.float32) for i in range(n)})
    assert float(tc.l2(_tt(no_bias))) == float(tc.l2(_tt(np_params)))


def test_fm_layers_match_jax():
    e, bias = _embeds(7), np.random.RandomState(8).randn(6, 5, 1).astype(np.float32)
    jf, tf = jax_layers.FMLayer(), layers.FMLayer()
    _layer_grads_match(lambda a, b: jf.apply({}, a, b, training=False),
                       lambda a, b: tf.apply({}, a, b, training=False), [e, bias])
    # keeps below 1 are a no-op outside training
    tf_drop = layers.FMLayer(dropout_keep=(0.5, 0.5))
    torch.testing.assert_close(
        tf_drop.apply({}, torch.as_tensor(e), torch.as_tensor(bias), training=False,
                      generator=torch.Generator()),
        tf.apply({}, torch.as_tensor(e), torch.as_tensor(bias)), rtol=0, atol=0)

    jw, tw = jax_layers.FwFMLayer(5, l2_reg=0.3), layers.FwFMLayer(5, l2_reg=0.3)
    r0 = tw.init(device="cpu")["fwfm_r"]
    assert torch.equal(r0, torch.as_tensor(np.asarray(jw.init()["fwfm_r"])))  # bit for bit
    # only the upper triangle is read
    r = np.random.RandomState(10).randn(5, 5).astype(np.float32)
    _layer_grads_match(lambda a, rr: jw.apply({"fwfm_r": rr}, a),
                       lambda a, rr: tw.apply({"fwfm_r": rr}, a), [e, r])
    r_low = r + np.tril(np.full((5, 5), 9.0, np.float32))
    torch.testing.assert_close(tw.apply({"fwfm_r": torch.as_tensor(r_low)}, torch.as_tensor(e)),
                               tw.apply({"fwfm_r": torch.as_tensor(r)}, torch.as_tensor(e)),
                               rtol=0, atol=0)
    assert abs(float(tw.l2({"fwfm_r": torch.as_tensor(r)}))
               - float(jw.l2({"fwfm_r": jnp.asarray(r)}))) <= 1e-6


def test_bi_interaction_pooling_matches_jax():
    e = _embeds(11)
    jb, tb = jax_layers.BiInteractionPooling(), layers.BiInteractionPooling()
    _layer_grads_match(lambda a: jb.apply({}, a, training=False),
                       lambda a: tb.apply({}, a, training=False), [e])
    # the pooled vector is FM's pairwise sum kept per k
    pooled = tb.apply({}, torch.as_tensor(e)).numpy()
    pairs = sum(e[:, i] * e[:, j] for i in range(5) for j in range(i + 1, 5))
    np.testing.assert_allclose(pooled, pairs, rtol=0, atol=1e-5)


def test_afm_layer_matches_jax():
    f, k, t = 5, 4, 3
    ja, ta = jax_layers.AFMLayer(f, k, att_factor=t, l2_reg=0.2), \
        layers.AFMLayer(f, k, att_factor=t, l2_reg=0.2)
    np_params = _np(ja.init(jax.random.PRNGKey(12)))
    drawn = ta.init(JaxKey(12), device="cpu")
    assert drawn["afm_att_h"].shape == (t,) and drawn["afm_p"].shape == (k, 1)
    for key in np_params:
        assert np.abs(drawn[key].numpy() - np_params[key]).max() <= ULPS
    np_params["afm_att_b"] = np.linspace(-0.5, 0.5, t).astype(np.float32)
    names = list(np_params)

    def jfn(x, *p):
        return ja.apply(dict(zip(names, p)), x, training=False)

    def tfn(x, *p):
        return ta.apply(dict(zip(names, p)), x, training=False)

    _layer_grads_match(jfn, tfn, [_embeds(13, f=f, k=k)] + [np_params[n] for n in names])
    assert abs(float(ta.l2(_tt(np_params))) - float(ja.l2(_jnp(np_params)))) <= 1e-6


@pytest.mark.parametrize("layers_n,inputs,outputs", [
    (1, 2, 1), (2, 5, 2), (3, 10, 1), (2, 7, 1), (4, 31, 1), (1, 2.75, 1), (1, 5.25, 1)])
def test_hidden_units_sizing_matches_jax(layers_n, inputs, outputs):
    """The half-way cases: s2 at 3.75 * 2/3 = 2.5 and s1 at 6.25 ** (1/2) =
    2.5 both round to 2, half to even, as Python's round does in both
    packages (integer widths give no exact half)."""
    for s in ("compute_hidden_units_s1", "compute_hidden_units_s2"):
        assert getattr(utils, s)(layers_n, inputs, outputs) == \
            getattr(jax_utils, s)(layers_n, inputs, outputs)
    if inputs in (2.75, 5.25):
        fn = utils.compute_hidden_units_s2 if inputs == 2.75 else utils.compute_hidden_units_s1
        assert fn(layers_n, inputs, outputs) == [2]


def test_auto_sized_dnn_matches_jax():
    """A hidden_units with a None entry is sized whole by the 2/3 rule of the
    input width, its given widths too, as the reference sizes it."""
    hp, inputs = (None, 4, None), 7
    jd = jax_layers.DNN(inputs, hp, (1.0,) * 4, "relu")
    td = layers.DNN(inputs, hp, (1.0,) * 4, "relu")
    assert td.hidden_units == jd.hidden_units == (5, 5, 5)
    np_params = _np(jd.init(jax.random.PRNGKey(0)))
    got = td.init(JaxKey(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in np_params.items()}
    for k in np_params:
        assert np.abs(got[k].numpy() - np_params[k]).max() <= ULPS
    x = np.random.RandomState(1).randn(3, inputs).astype(np.float32)
    np.testing.assert_allclose(td.apply(_tt(np_params), torch.as_tensor(x)).numpy(),
                               np.asarray(jd.apply(_jnp(np_params), jnp.asarray(x), training=False)),
                               rtol=0, atol=PRED_TOL)
    assert utils.count_parameters(got) == jax_utils.count_parameters(np_params) == \
        7 * 5 + 5 + 5 * 5 + 5 + 5 * 5 + 5 + 5 + 1


# -- the reference's initial params without JAX -----------------------------

@pytest.mark.parametrize("seed", [0, 2019, 2**32 - 1])
def test_jax_key_draws_match_jax_random(seed):
    key, jkey = JaxKey(seed), jax.random.PRNGKey(seed)
    assert key.words == tuple(int(w) for w in np.asarray(jax.random.key_data(jkey)))
    for sub, jsub in zip(key.split(3), jax.random.split(jkey, 3)):
        assert sub.words == tuple(int(w) for w in np.asarray(jsub))
        np.testing.assert_array_equal(sub.bits((7, 5)), np.asarray(jax.random.bits(jsub, (7, 5))))
        for lo, hi in ((0.0, 1.0), (-0.3, 0.7), (-0.9544997, 0.9544997)):
            ref = np.asarray(jax.random.uniform(jsub, (33, 9), minval=lo, maxval=hi))
            np.testing.assert_array_equal(uniform(sub, (33, 9), lo, hi).view(np.uint32),
                                          ref.view(np.uint32))
        ref = np.asarray(jax.random.truncated_normal(jsub, -2.0, 2.0, (200, 8)))
        got = truncated_normal(sub, -2.0, 2.0, (200, 8))
        assert np.abs(got - ref).max() <= ULPS and (np.abs(got) < 2.0).all()


@pytest.mark.parametrize("name", ZOO + ("xdeepfm",))
def test_init_state_from_a_jax_key_matches_the_jax_trainer(name, synthetic_df):
    """``init_state`` on ``JaxKey(seed)`` gives the JAX Trainer's initial
    params for the same seed."""
    hp = {"learning_rate": 1e-3}
    jt = JaxTrainer(jax_models.MODEL_REGISTRY[name](_schema(recman_tpu, synthetic_df), hp), hp,
                    random_seed=7)
    tt = Trainer(models.model_class(name)(_schema(recman_tpu_torch, synthetic_df), hp), hp,
                 device="cpu")
    state = init_state(tt.model, tt.optimizer, JaxKey(7), device="cpu")
    ref, got = _np(jt.state.params), state.params
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and np.abs(got[k].numpy() - ref[k]).max() <= ULPS, k


# -- the Trainer, checkpoints, the example -----------------------------------

FRAC = 0.01


@pytest.fixture(scope="module")
def ml():
    jtr, jva, _, jdom = jax_ml_dataset(frac=FRAC, random_seed=2019)
    jfs = jax_ml_features(pd.concat([jtr, jva]), jdom)
    ttr, tva, _, tdom = get_ml_dataset(frac=FRAC, random_seed=2019)
    tfs = create_ml_features(concat_rows(ttr, tva), tdom)
    return {"jax": (jfs, jfs.transform(jtr), jtr["label"].values, jfs.transform(jva)),
            "port": (tfs, tfs.transform(ttr), ttr["label"], tfs.transform(tva))}


@pytest.mark.parametrize("name", ["deepfm", "dcn"])
def test_fit_matches_jax_trainer(name, ml):
    """One epoch on the kernels' route (the JAX Pallas kernels interpreted,
    the port's K6 twins), from the same params."""
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
    with torch_emb.fused_grad(True), torch_emb.grad_kernel("segmat"):
        tt.fit(xtr, ytr, random_seed_for_mini_batch=False)
        preds = tt.predict(xva)
    assert abs(tt.last_mean_loss - jt.last_mean_loss) <= FIT_LOSS_REL * abs(jt.last_mean_loss)
    assert np.abs(preds - ref_preds).max() <= FIT_PRED_ABS


def test_predictor_from_checkpoint_matches_jax(synthetic_df, tmp_path):
    """A port-saved deepfm checkpoint serves JAX's predictions for the same
    params."""
    hp = {**KEEPS["deepfm"], "learning_rate": 0.01}
    jm, tm, np_params = _pair("deepfm", synthetic_df, hp)
    tt = Trainer(tm, hp, batch_size=8, device="cpu")
    tt.state = tt.state._replace(params=params_from_jax(np_params, device="cpu"))
    tt.save(tmp_path)
    tp = Predictor.from_checkpoint(tmp_path, "deepfm", hparams=hp, batch_size=8, device="cpu")
    assert isinstance(tp.model, models.DeepFM) and tp.device.type == "cpu"
    ref = JaxPredictor(jm, _jnp(np_params), batch_size=8).predict(synthetic_df)
    np.testing.assert_allclose(tp.predict(synthetic_df), ref, rtol=0, atol=PRED_TOL)
    np.testing.assert_array_equal(tp.predict(synthetic_df), tt.predict(synthetic_df))


def test_run_model_and_unported_models(capsys):
    trainer, (logloss, auc) = run_model("fm", frac=0.02, device="cpu")
    assert isinstance(trainer.model, models.FM) and trainer.device.type == "cpu"
    assert np.isfinite(logloss) and 0.0 <= auc <= 1.0
    assert "hist_items" not in trainer.model.feat_dict
    # the whole zoo is ported: the registry is the reference's, and an
    # unknown name raises as the reference's MODEL_REGISTRY[name] does
    assert set(models.MODEL_REGISTRY) == set(recman_tpu.models.MODEL_REGISTRY)
    assert set(models.MODEL_REGISTRY) >= set(ZOO) | {"xdeepfm", "din", "bst", "dien"}
    with pytest.raises(KeyError, match="no_such_model"):
        run_model("no_such_model", frac=0.02, device="cpu")

    # a model that sets requires_sequence trains on the history schema
    class SequenceFM(models.FM):
        requires_sequence = True

    models.MODEL_REGISTRY["sequence_fm"] = SequenceFM
    try:
        trainer, (logloss, auc) = run_model("sequence_fm", frac=0.02, device="cpu")
    finally:
        del models.MODEL_REGISTRY["sequence_fm"]
    hist = trainer.model.feat_dict["hist_items"]
    assert hist.id_feat is trainer.model.feat_dict["item_id"] and hist.max_len == 10
    assert np.isfinite(logloss) and 0.0 <= auc <= 1.0
    assert not models.Model.requires_sequence and not models.Model.supports_moment_capture
    assert models.Model.inference_dropout((0.5, 0.8)) == (1.0, 1.0)
