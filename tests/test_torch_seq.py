"""The port's behaviour-sequence family (recman_tpu_torch) against the JAX
package on the CPU: Dice and its batch moments, the Dice DNN, DIN's
attention pooling, BST's LayerNorm and encoder, DIEN's GRU, AUGRU and
auxiliary loss, the DIN, BST and DIEN models, ``Trainer.calibrate``, the
ML-100K history feature, ``Trainer.fit`` and ``examples.din_synthetic``.

Inputs are the reference's 16-row synthetic fixture with every feature
type, a behavior sequence tied to CLASS_ID among them
(``test_torch_xdeepfm._schema``, max_len 4 so that every row has padding,
and one row with no history at all); params are drawn by JAX, every
zero-initialised vector given random values from a numpy seed and every
Dice variance a random positive value, and carried across with
``convert.params_from_jax``; every dropout keep is 1.

Tolerances, those of ``test_torch_zoo.py``:
- eval predictions 1e-5 absolute;
- the training loss 1e-6 relative;
- every gradient 1e-5 of its leaf's max|ref|, on each package's default
  CPU route and on the kernels' route (K6's twin under ``fused_grad(True),
  grad_kernel("segmat")``);
- layer outputs 1e-5 of max|ref|;
- the moments ``calibrate`` writes 1e-6 of max|ref|, and predictions of
  the same rows at two batch sizes 1e-6 absolute;
- ``Trainer.fit`` and ``din_synthetic.main``: the epoch mean loss 1e-4
  relative, the predictions 1e-4 absolute;
- whole models' initial params from ``JaxKey`` within 2 float32 ulps of 1.
"""

import warnings

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
from recman_tpu.data import add_history_feature as jax_add_history
from recman_tpu.data import create_ml_sequence_features as jax_seq_features
from recman_tpu.data import get_ml_dataset as jax_ml_dataset
from recman_tpu.examples import din_synthetic as jax_din_synthetic
from recman_tpu.serving import Predictor as JaxPredictor
from recman_tpu.layers.bst import TransformerEncoderLayer as JaxEncoder
from recman_tpu.layers.dien import InterestEvolution as JaxEvolution
from recman_tpu.layers.masknet import LayerNorm as JaxLayerNorm
from recman_tpu.training import LogLoss as JaxLogLoss
from recman_tpu.training import Trainer as JaxTrainer
from recman_tpu_torch import layers, models
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.data import (
    add_history_feature,
    concat_rows,
    create_ml_sequence_features,
    get_ml_dataset,
)
from recman_tpu_torch.examples import din_synthetic
from recman_tpu_torch.layers.bst import TransformerEncoderLayer
from recman_tpu_torch.layers.dien import InterestEvolution
from recman_tpu_torch.ops import embedding as torch_emb
from recman_tpu_torch.serving import Predictor
from recman_tpu_torch.training import LogLoss, Trainer, init_state
from recman_tpu_torch.training.train_step import loss_and_grads
from recman_tpu_torch.utils import JaxKey
from tests.test_torch_xdeepfm import _schema
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

PRED_TOL = 1e-5
LOSS_REL = 1e-6
GRAD_TOL = 1e-5
OUT_TOL = 1e-5
MOMENT_REL = 1e-6
BATCH_TOL = 1e-6  # the same rows predicted at two batch sizes
ULPS = 2.4e-7
FIT_LOSS_REL, FIT_PRED_ABS = 1e-4, 1e-4
MAX_LEN = 4

SEQ = ("din", "bst", "dien")


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _max_rel(ref, got):
    scale = float(np.abs(ref).max()) or 1.0
    return float(np.abs(np.asarray(got) - ref).max()) / scale


def _assert_close(ref, got, tol, what):
    assert np.asarray(got).shape == np.asarray(ref).shape, what
    err = _max_rel(np.asarray(ref), got)
    assert err <= tol, f"{what}: max|d|/max|ref| {err} > {tol}"


def _assert_grads(ref, got, what, zero=()):
    """Every leaf within GRAD_TOL of its max|ref|. A leaf in ``zero`` has a
    gradient of 0 in exact arithmetic (the attention score's bias under
    the softmax, which no shift of the scores moves), so both packages
    give rounding noise there: it is held to GRAD_TOL of the largest
    gradient of any leaf instead."""
    assert set(got) == set(ref)
    largest = max(float(np.abs(v).max()) for v in ref.values()) or 1.0
    for k in ref:
        scale = largest if k in zero else (float(np.abs(ref[k]).max()) or 1.0)
        err = float(np.abs(np.asarray(got[k]) - ref[k]).max())
        assert err <= GRAD_TOL * scale, f"{what} {k}: {err} > {GRAD_TOL} * {scale}"


def _randomise(params, seed=0):
    """Every zero-initialised vector random, every Dice variance random
    and positive, so that each term takes part."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if "_dice_var_" in k:
            v = (0.5 + rs.rand(*v.shape)).astype(np.float32)
        elif not v.any():
            v = (0.3 * rs.randn(*v.shape)).astype(np.float32)
        out[k] = v
    return out


def _grads_both(jax_fn, torch_fn, args, seed=1):
    """Gradients of sum(out * w) for a fixed random w, with respect to every
    float array of ``args``, in both packages. Returns (jax out, jax grads,
    port out, port grads)."""
    ref_out = np.asarray(jax.jit(jax_fn)(_jnp(args)))
    w = np.asarray(np.random.RandomState(seed).randn(*ref_out.shape), dtype=np.float32)
    ref_grads = _np(jax.jit(jax.grad(lambda a: jnp.sum(jax_fn(a) * w)))(_jnp(args)))
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in args.items()}
    out = torch_fn(leaves)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), list(leaves.values()),
                                allow_unused=True)
    got = {k: (torch.zeros_like(p) if g is None else g).numpy()
           for (k, p), g in zip(leaves.items(), grads)}
    return ref_out, ref_grads, out.detach().numpy(), got


def _inputs(rs, b=6, l=5, k=4, empty_row=True):
    """Queries (B, k), keys (B, L, k) zeroed where masked, a (B, L) mask
    with padding in every row and, with ``empty_row``, one row masked
    whole."""
    lengths = rs.randint(1, l, size=b)
    if empty_row:
        lengths[1] = 0
    mask = np.arange(l)[None, :] < lengths[:, None]
    keys = (rs.randn(b, l, k) * mask[:, :, None]).astype(np.float32)
    return rs.randn(b, k).astype(np.float32), keys, mask


# -- Dice ----------------------------------------------------------------------

def test_dice_and_batch_moments_match_jax():
    """The population variance (``correction=0``), eps 1e-8 inside the
    rsqrt, and the gradient through the batch moments, not stopped."""
    rs = np.random.RandomState(0)
    args = {"x": (rs.randn(33, 7) * 3 + 1).astype(np.float32),
            "alpha": rs.randn(7).astype(np.float32)}
    ref_m, ref_v = jax_layers.common.batch_moments(jnp.asarray(args["x"]))
    m, v = layers.batch_moments(torch.tensor(args["x"]))
    _assert_close(np.asarray(ref_m), m.numpy(), 1e-6, "batch mean")
    _assert_close(np.asarray(ref_v), v.numpy(), 1e-6, "batch var")
    assert np.allclose(v.numpy(), args["x"].var(axis=0), rtol=1e-5)  # not the unbiased one

    ref, ref_g, got, got_g = _grads_both(
        lambda a: jax_layers.dice(a["x"], a["alpha"]), lambda a: layers.dice(a["x"], a["alpha"]),
        args)
    _assert_close(ref, got, OUT_TOL, "dice, batch moments")
    _assert_grads(ref_g, got_g, "dice, batch moments")

    mean, var = rs.randn(7).astype(np.float32), (0.5 + rs.rand(7)).astype(np.float32)
    ref = np.asarray(jax_layers.dice(jnp.asarray(args["x"]), jnp.asarray(args["alpha"]),
                                     jnp.asarray(mean), jnp.asarray(var)))
    got = layers.dice(torch.tensor(args["x"]), torch.tensor(args["alpha"]), torch.tensor(mean),
                      torch.tensor(var)).numpy()
    _assert_close(ref, got, OUT_TOL, "dice, stored moments")
    # a zero-variance unit: eps keeps it finite, as in the reference
    x0 = np.ones((4, 2), np.float32)
    ref = np.asarray(jax_layers.dice(jnp.asarray(x0), jnp.zeros(2)))
    got = layers.dice(torch.tensor(x0), torch.zeros(2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=PRED_TOL)
    assert layers.resolve_activation("dice") is layers.dice


@pytest.mark.parametrize("training", [True, False])
def test_dice_dnn_matches_jax(training):
    """Params and their order, the output, every gradient, and the moments
    ``moment_capture`` records in training."""
    rs = np.random.RandomState(2)
    jd = jax_layers.DNN(12, (9, 5), (1, 1, 1), "dice", prefix="p_")
    td = layers.DNN(12, (9, 5), (1, 1, 1), "dice", prefix="p_")
    params = _randomise(jd.init(jax.random.PRNGKey(3)))
    own = td.init(JaxKey(3), device="cpu")
    assert list(own) == list(params)
    assert [k for k in params if "dice" in k] == [
        f"p_dnn_dice_{n}_{i}" for i in range(2) for n in ("alpha", "mean", "var")]
    args = {"x": rs.randn(20, 12).astype(np.float32), **params}

    ref, ref_g, got, got_g = _grads_both(
        lambda a: jd.apply(a, a["x"], training=training),
        lambda a: td.apply(a, a["x"], training=training), args)
    _assert_close(ref, got, OUT_TOL, "dice dnn")
    _assert_grads(ref_g, got_g, "dice dnn")
    moment_names = [k for k in params if "_dice_mean_" in k or "_dice_var_" in k]
    # training reads the batch's moments: the stored ones take no gradient
    assert all(bool(got_g[k].any()) != training for k in moment_names)

    ref_cap, cap = {}, {}
    jd.apply(_jnp(params), jnp.asarray(args["x"]), training=training, moment_capture=ref_cap)
    with torch.no_grad():
        td.apply(_tt(params), torch.tensor(args["x"]), training=training, moment_capture=cap)
    assert list(cap) == list(ref_cap) == (moment_names if training else [])
    for k in cap:
        _assert_close(np.asarray(ref_cap[k]), cap[k].numpy(), MOMENT_REL, k)


# -- DIN's attention pooling -----------------------------------------------------

@pytest.mark.parametrize("activation", ["dice", "sigmoid"])
@pytest.mark.parametrize("weight_normalization", [False, True])
def test_asp_layer_matches_jax(activation, weight_normalization):
    """Both activations and both routes of the weights (masked softmax,
    raw masked scores); a row with no history; the gradient of the
    queries, the keys and every param, in training (Dice on the B·L
    positions' batch moments, padding included) and at inference."""
    rs = np.random.RandomState(4)
    kw = dict(att_hidden_units=(6, 3), activation=activation,
              weight_normalization=weight_normalization, prefix="s_")
    jl, tl = jax_layers.ASPLayer(4, **kw), layers.ASPLayer(4, **kw)
    params = _randomise(jl.init(jax.random.PRNGKey(5)))
    assert list(tl.init(JaxKey(5), device="cpu")) == list(params)
    q, keys, mask = _inputs(rs)
    for training in (True, False):
        args = {"q": q, "keys": keys, **params}
        ref, ref_g, got, got_g = _grads_both(
            lambda a: jl.apply(a, a["q"], a["keys"], jnp.asarray(mask), training=training),
            lambda a: tl.apply(a, a["q"], a["keys"], torch.tensor(mask), training=training),
            args)
        _assert_close(ref, got, OUT_TOL, f"asp training={training}")
        _assert_grads(ref_g, got_g, f"asp training={training}",
                      zero=("s_asp_w0",) if weight_normalization else ())
        assert not got[1].any()  # the empty row pools to zero


# -- BST's encoder -----------------------------------------------------------------

def test_layer_norm_matches_jax():
    rs = np.random.RandomState(6)
    jn, tn = JaxLayerNorm(5, "n_"), layers.LayerNorm(5, "n_")
    params = _randomise(jn.init())
    params["n_ln_gamma"] = rs.randn(5).astype(np.float32)
    assert list(tn.init("cpu")) == list(params) and tn.eps == 1e-6
    # one row of equal values: its variance is 0 and eps decides the output
    x = np.concatenate([rs.randn(7, 3, 5), np.full((1, 3, 5), 2.0)]).astype(np.float32)
    ref, ref_g, got, got_g = _grads_both(
        lambda a: jn.apply(a, a["x"]), lambda a: tn.apply(a, a["x"]), {"x": x, **params})
    _assert_close(ref, got, OUT_TOL, "layer norm")
    _assert_grads(ref_g, got_g, "layer norm")


@pytest.mark.parametrize("training", [True, False])
def test_bst_encoder_matches_jax(training):
    """The encoder block with padded keys (-1e9 added to their scores,
    the candidate's slot always on); every gradient."""
    rs = np.random.RandomState(7)
    kw = dict(model_dim=4, num_heads=2, ff_hidden=6, activation="leaky_relu", l2_reg=0.01,
              prefix="e_")
    je, te = JaxEncoder(**kw), TransformerEncoderLayer(**kw)
    params = _randomise(je.init(jax.random.PRNGKey(8)))
    assert list(te.init(JaxKey(8), device="cpu")) == list(params)
    _, x, mask = _inputs(rs, l=6)
    mask[:, -1] = True  # the candidate's slot
    ref, ref_g, got, got_g = _grads_both(
        lambda a: je.apply(a, a["x"], jnp.asarray(mask), training=training),
        lambda a: te.apply(a, a["x"], torch.tensor(mask), training=training),
        {"x": x, **params})
    _assert_close(ref, got, OUT_TOL, "bst encoder")
    _assert_grads(ref_g, got_g, "bst encoder")
    ref_l2 = float(je.l2(_jnp(params)))
    assert abs(float(te.l2(_tt(params))) - ref_l2) <= LOSS_REL * ref_l2


# -- DIEN ----------------------------------------------------------------------------

def test_dien_extract_evolve_and_aux_loss_match_jax():
    """The GRU carries h through masked steps, the AUGRU's attention scales
    the update gate, the auxiliary loss reads in-batch negatives rolled by
    one row; its denominator is max(sum(valid), 1)."""
    rs = np.random.RandomState(9)
    je, te = JaxEvolution(4, 3, l2_reg=0.01, prefix="h_"), InterestEvolution(4, 3, l2_reg=0.01,
                                                                            prefix="h_")
    params = _randomise(je.init(jax.random.PRNGKey(10)))
    own = te.init(JaxKey(10), device="cpu")
    assert list(own) == list(params)
    ref_init = _np(je.init(jax.random.PRNGKey(10)))
    assert all(np.abs(own[k].numpy() - ref_init[k]).max() <= ULPS for k in ref_init)
    q, seq, mask = _inputs(rs)
    jm, tm = jnp.asarray(mask), torch.tensor(mask)
    args = {"q": q, "seq": seq, **params}

    ref, ref_g, got, got_g = _grads_both(lambda a: je.extract(a, a["seq"], jm),
                                         lambda a: te.extract(a, a["seq"], tm), args)
    _assert_close(ref, got, OUT_TOL, "extract")
    _assert_grads(ref_g, got_g, "extract")
    assert not got[1].any()  # no history: h stays 0 through every step
    ref, ref_g, got, got_g = _grads_both(
        lambda a: je.evolve(a, je.extract(a, a["seq"], jm), jm, a["q"]),
        lambda a: te.evolve(a, te.extract(a, a["seq"], tm), tm, a["q"]), args)
    _assert_close(ref, got, OUT_TOL, "evolve")
    _assert_grads(ref_g, got_g, "evolve")
    ref, ref_g, got, got_g = _grads_both(
        lambda a: je.aux_loss(a, je.extract(a, a["seq"], jm), a["seq"], jm),
        lambda a: te.aux_loss(a, te.extract(a, a["seq"], tm), a["seq"], tm), args)
    _assert_close(ref, got, OUT_TOL, "aux loss")
    _assert_grads(ref_g, got_g, "aux loss")
    # no valid (t, t+1) pair: the loss is 0, not a division by 0
    none = np.zeros_like(mask)
    none[:, 0] = True
    states = te.extract(_tt(params), torch.tensor(seq), torch.tensor(none))
    assert float(te.aux_loss(_tt(params), states, torch.tensor(seq), torch.tensor(none))) == 0.0


# -- the models ----------------------------------------------------------------------

VARIANTS = [
    ("din", {}),
    ("din", {"att_activation": "sigmoid", "att_weight_normalization": True,
             "deep_activation": "relu"}),
    ("bst", {}),
    ("bst", {"num_blocks": 2, "deep_activation": "dice", "trans_l2_reg": 0.01}),
    ("dien", {}),
    ("dien", {"aux_loss_weight": 0.5, "gru_hidden": 5}),
]


def _seq_df(df):
    """The fixture with one row of no history."""
    df = df.copy()
    df.at[1, "SEQUENCE_VAL_1"] = []
    return df


def _pair(name, df, hparams=None):
    jm = jax_models.MODEL_REGISTRY[name](_schema(recman_tpu, df, MAX_LEN), hparams)
    tm = models.model_class(name)(_schema(recman_tpu_torch, df, MAX_LEN), hparams)
    return jm, tm, _randomise(jm.init_params(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name,hparams", VARIANTS)
def test_model_matches_jax(name, hparams, synthetic_df):
    """Params (names, order, shapes), eval predictions on the stored
    moments, the training loss and every gradient, on both routes of the
    lookups' backward; the moment params get none."""
    df = _seq_df(synthetic_df)
    jm, tm, np_params = _pair(name, df, hparams)
    own = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in np_params.items()}
    params = params_from_jax(np_params, device="cpu")
    assert list(params) == list(np_params)

    batch = tm.feat_dict.transform(df, y=df["LABEL"].values)
    assert (batch["SEQUENCE_VAL_1"] < 0).any(axis=1).all() and (batch["SEQUENCE_VAL_1"][1] < 0).all()
    ref = np.asarray(jax.jit(lambda p, b: jm.apply(p, b, training=False))(
        _jnp(np_params), _jnp(batch)))
    with torch.inference_mode():
        got = tm.apply(params, _tt(batch)).numpy()
    assert got.shape == (16,)
    assert np.abs(ref - got).max() <= PRED_TOL

    fn = lambda p, b: jm.loss(p, b, training=True, rng=None)  # noqa: E731
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(fn))(_jnp(np_params), _jnp(batch))
    ref_loss, ref_grads = float(ref_loss), _np(ref_grads)
    for route in ("default", "kernels"):
        with torch_emb.fused_grad(route == "kernels"), \
                torch_emb.grad_kernel("segmat" if route == "kernels" else "auto"):
            loss, grads = loss_and_grads(tm, params, _tt(batch))
        assert abs(loss.item() - ref_loss) <= LOSS_REL * abs(ref_loss), route
        zero = [k for k in grads if k.endswith("_asp_w0")
                and hparams.get("att_weight_normalization")]
        _assert_grads(ref_grads, grads, f"{name} [{route}]", zero)
        assert all(not grads[k].any() for k in grads if "_dice_mean_" in k or "_dice_var_" in k)
    if hparams.get("aux_loss_weight"):
        plain = jax_models.MODEL_REGISTRY[name](jm.feat_dict, {**hparams, "aux_loss_weight": 0.0})
        ref_plain = float(jax.jit(lambda p, b: plain.loss(p, b, training=True, rng=None))(
            _jnp(np_params), _jnp(batch)))
        assert abs(ref_loss - ref_plain) > 1e-3  # the auxiliary term takes part


@pytest.mark.parametrize("name", SEQ)
def test_init_state_from_a_jax_key_matches_the_jax_trainer(name, synthetic_df):
    hp = {"learning_rate": 1e-3}
    jt = JaxTrainer(jax_models.MODEL_REGISTRY[name](_schema(recman_tpu, synthetic_df), hp), hp,
                    random_seed=2019)
    tt = Trainer(models.model_class(name)(_schema(recman_tpu_torch, synthetic_df), hp), hp,
                 device="cpu")
    state = init_state(tt.model, tt.optimizer, JaxKey(2019), device="cpu")
    ref, got = _np(jt.state.params), state.params
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and np.abs(got[k].numpy() - ref[k]).max() <= ULPS, k


# -- the ML-100K history feature ----------------------------------------------------

@pytest.fixture(scope="module")
def ml_frames():
    """Both loaders at frac 0.5, the port's with its row labels."""
    return jax_ml_dataset(frac=0.5, random_seed=2019), get_ml_dataset(
        frac=0.5, random_seed=2019, return_index=True)


def _assert_same_history(ref_frames, got_tables):
    for jdf, t in zip(ref_frames, got_tables):
        ref = jdf["hist_items"].tolist()
        assert len(t["hist_items"]) == len(ref)
        for r, g in zip(ref, t["hist_items"]):
            assert g.dtype == np.int64 and g.tolist() == [int(v) for v in r]


def test_history_feature_matches_pandas_on_ml_100k(ml_frames):
    """Element for element on the three splits run_model builds it over,
    then encoded by the sequence schema."""
    (jtr, jva, jte, jdom), (ttr, tva, tte, tdom, index) = ml_frames
    for jdf, labels in zip((jtr, jva, jte), index):
        np.testing.assert_array_equal(labels, jdf.index.values)
    ref = jax_add_history(jtr, jva, jte)
    got = add_history_feature(ttr, tva, tte, index=index)
    _assert_same_history(ref, got)
    # ties of user and timestamp inside a split follow the row labels:
    # ordered by position instead, 31,981 rows get another history
    by_position = add_history_feature(ttr, tva, tte)
    moved = sum(a.tolist() != b.tolist() for g, p in zip(got, by_position)
                for a, b in zip(g["hist_items"], p["hist_items"]))
    assert moved == 31_981
    assert list(got[0]) == list(ttr) + ["hist_items"] and "hist_items" not in ttr
    jfs = jax_seq_features(pd.concat(ref[:2]), jdom)
    tfs = create_ml_sequence_features(concat_rows(*got[:2]), tdom)
    assert tfs["hist_items"].id_feat is tfs["item_id"] and tfs["hist_items"].max_len == 10
    for jdf, t in zip(ref, got):
        np.testing.assert_array_equal(tfs.transform(t)["hist_items"],
                                      jfs.transform(jdf)["hist_items"])


def test_history_feature_orders_ties_across_frames():
    """Rows tied on user and timestamp: frame order first, then the row
    label, never the row's position; history only from strictly earlier
    rows of the sort, the last max_len of them."""
    a = pd.DataFrame({"user_id": [1, 1, 2, 1, 1], "timestamp": [5, 5, 1, 3, 5],
                      "item_id": [10, 11, 20, 12, 13]}, index=[7, 3, 0, 9, 5])
    b = pd.DataFrame({"user_id": [1, 2, 1], "timestamp": [5, 1, 2], "item_id": [30, 31, 32]},
                     index=[1, 0, 2])
    for max_len in (2, 10):
        ref = jax_add_history(a, b, max_len=max_len)
        got = add_history_feature(
            *({k: v.values for k, v in df.items()} for df in (a, b)), max_len=max_len,
            index=(a.index.values, b.index.values))
        _assert_same_history(ref, got)
    one = add_history_feature({"user_id": np.array([4, 4]), "timestamp": np.array([2, 1]),
                               "item_id": np.array([8, 9])})
    assert [h.tolist() for h in one["hist_items"]] == [[9], []]


# -- Trainer.calibrate, Trainer.fit, the example --------------------------------------

FRAC = 0.01


@pytest.fixture(scope="module")
def ml_seq():
    """Both packages' sequence schemas at FRAC, each encoding its own
    loader's splits."""
    jtr, jva, jte = jax_add_history(*jax_ml_dataset(frac=FRAC, random_seed=2019)[:3])
    jdom = jax_ml_dataset(frac=FRAC, random_seed=2019)[3]
    jfs = jax_seq_features(pd.concat([jtr, jva]), jdom)
    ttr, tva, tte, tdom, index = get_ml_dataset(frac=FRAC, random_seed=2019, return_index=True)
    ttr, tva, tte = add_history_feature(ttr, tva, tte, index=index)
    tfs = create_ml_sequence_features(concat_rows(ttr, tva), tdom)
    return {"jax": (jfs, jfs.transform(jtr), jtr["label"].values, jfs.transform(jva)),
            "port": (tfs, tfs.transform(ttr), ttr["label"], tfs.transform(tva))}


@pytest.mark.parametrize("name", ["din", "dien"])
def test_calibrate_matches_jax(name, ml_seq):
    """The moments calibrate writes, then eval predictions on them; the
    same rows predicted at two batch sizes agree within 1e-6 (batch
    moments would move them by far more)."""
    hp = {"learning_rate": 1e-3}
    jfs, xtr, _, xva = ml_seq["jax"]
    tfs, xtr_t, _, xva_t = ml_seq["port"]
    jt = JaxTrainer(jax_models.MODEL_REGISTRY[name](jfs, hp), hp, batch_size=128)
    np_params = _randomise(jt.state.params)
    jt.state = jt.state._replace(params=_jnp(np_params))
    tt = Trainer(models.model_class(name)(tfs, hp), hp, batch_size=128, device="cpu")
    tt.state = tt.state._replace(params=params_from_jax(np_params, device="cpu"))
    assert jt.calibrate(xtr) and tt.calibrate(xtr_t)
    ref, got = _np(jt.state.params), tt.state.params
    names = [k for k in ref if "_dice_mean_" in k or "_dice_var_" in k]
    assert len(names) == (8 if name == "din" else 4)
    for k in ref:
        if k in names:
            assert not np.array_equal(ref[k], np_params[k])
            _assert_close(ref[k], got[k].numpy(), MOMENT_REL, k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np_params[k])
    preds = tt.predict(xva_t)
    np.testing.assert_allclose(preds, jt.predict(xva), rtol=0, atol=PRED_TOL)
    tt.batch_size = 7
    np.testing.assert_allclose(tt.predict(xva_t), preds, rtol=0, atol=BATCH_TOL)


def test_calibrate_warns_for_dice_without_moment_capture(synthetic_df):
    """BST with a Dice DNN has moments but no capture, in both packages."""
    hp = {"learning_rate": 1e-3, "deep_activation": "dice"}
    batch = None
    for pkg, trainer_cls, kw in ((recman_tpu, JaxTrainer, {}),
                                 (recman_tpu_torch, Trainer, {"device": "cpu"})):
        registry = jax_models.MODEL_REGISTRY if pkg is recman_tpu else models.MODEL_REGISTRY
        fs = _schema(pkg, synthetic_df)
        t = trainer_cls(registry["bst"](fs, hp), hp, **kw)
        assert any("_dice_mean_" in k for k in t.state.params)
        batch = fs.transform(synthetic_df)
        with pytest.warns(UserWarning, match="does not support moment capture"):
            assert t.calibrate(batch) is False
    plain = Trainer(models.model_class("bst")(_schema(recman_tpu_torch, synthetic_df)),
                    {"learning_rate": 1e-3}, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert plain.calibrate(batch) is False


def test_fit_matches_jax_trainer(ml_seq):
    """DIN, one epoch from the same params: the JAX package on its default
    CPU route (XLA's scatter-add), the port on the kernels' route (K6's
    twin for each of the 7 lookups); Adam leaves the moment params and
    their state as JAX's does."""
    hp = {"learning_rate": 1e-3}
    jfs, xtr, ytr, xva = ml_seq["jax"]
    jt = JaxTrainer(jax_models.DIN(jfs, hp), hp, metrics=(JaxLogLoss(),), epoch=1,
                    batch_size=128, random_seed=2019)
    jt.fit(xtr, ytr, random_seed_for_mini_batch=False)
    ref_preds = jt.predict(xva)
    tfs, xtr, ytr, xva = ml_seq["port"]
    tt = Trainer(models.DIN(tfs, hp), hp, metrics=(LogLoss(),), epoch=1, batch_size=128,
                 device="cpu")
    tt.state = init_state(tt.model, tt.optimizer, JaxKey(2019), device="cpu")
    with torch_emb.fused_grad(True), torch_emb.grad_kernel("segmat"):
        tt.fit(xtr, ytr, random_seed_for_mini_batch=False)
        preds = tt.predict(xva)
    assert abs(tt.last_mean_loss - jt.last_mean_loss) <= FIT_LOSS_REL * abs(jt.last_mean_loss)
    assert np.abs(preds - ref_preds).max() <= FIT_PRED_ABS
    ref_params = _np(jt.state.params)
    ref_mu, ref_nu = (_np(getattr(jt.state.opt_state[0], f)) for f in ("mu", "nu"))
    for k in (k for k in ref_params if "_dice_var_" in k or "_dice_mean_" in k):
        _assert_close(ref_params[k], tt.state.params[k].numpy(), MOMENT_REL, k)
        assert not ref_mu[k].any() and not ref_nu[k].any()
        assert not tt.state.opt_state.mu[k].any() and not tt.state.opt_state.nu[k].any()


def test_predictor_from_checkpoint_serves_din_like_jax(synthetic_df, tmp_path):
    """A port-saved DIN checkpoint (the sequence feature in its sidecar)
    serves JAX's predictions for the same params, moments included, at
    any batch size."""
    hp = {"learning_rate": 1e-3}
    df = _seq_df(synthetic_df)
    jm, tm, np_params = _pair("din", df, hp)
    tt = Trainer(tm, hp, batch_size=8, device="cpu")
    tt.state = tt.state._replace(params=params_from_jax(np_params, device="cpu"))
    tt.save(tmp_path)
    ref = JaxPredictor(jm, _jnp(np_params), batch_size=8).predict(df)
    for bs in (8, 5):
        tp = Predictor.from_checkpoint(tmp_path, "din", hparams=hp, batch_size=bs, device="cpu")
        assert isinstance(tp.model, models.DIN)
        assert tp.model.feat_dict["SEQUENCE_VAL_1"].max_len == MAX_LEN
        np.testing.assert_allclose(tp.predict(df), ref, rtol=0, atol=PRED_TOL)


def test_din_synthetic_matches_jax():
    """``main(epoch=1)`` for din against the reference's example: the same
    rows, params and shuffle."""
    np.random.seed(2019)
    jt, ref = jax_din_synthetic.main(epoch=1, model_name="din")
    np.random.seed(2019)
    tt, got = din_synthetic.main(epoch=1, model_name="din", device="cpu")
    assert tt.device.type == "cpu" and isinstance(tt.model, models.DIN)
    assert abs(tt.last_mean_loss - jt.last_mean_loss) <= FIT_LOSS_REL * abs(jt.last_mean_loss)
    assert abs(got[0] - ref[0]) <= FIT_PRED_ABS and abs(got[1] - ref[1]) <= FIT_PRED_ABS
    data = din_synthetic.make_data(n=50)
    ref_df = jax_din_synthetic.make_data(n=50)
    assert data["item_id"].tolist() == ref_df["item_id"].tolist()
    assert list(data["hist_items"]) == ref_df["hist_items"].tolist()
    np.testing.assert_array_equal(data["label"], ref_df["label"].values)
