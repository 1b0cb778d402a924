"""The port's attention, bilinear, mask and gated models (recman_tpu_torch)
against the JAX package on the CPU: InteractingLayer, AutoInt,
SENETLayer, BilinearInteraction, FiBiNET, MaskBlock, MaskNet, the
FinalMLP layers and FinalMLP.

Inputs, params and tolerances are those of ``test_torch_zoo_cross.py``,
whose helpers this file shares: the 16-row synthetic fixture and the
small Criteo-shaped set, JAX's params carried across, every dropout keep
at 1; initial params from ``JaxKey`` within 2.4e-7, eval predictions
1e-5, the training loss 1e-6 relative, every gradient 1e-5 of its leaf's
max|ref| on both backward routes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recman_tpu import layers as jax_layers
from recman_tpu.layers import autoint as jax_autoint
from recman_tpu.layers import masknet as jax_masknet
from recman_tpu.layers import senet as jax_senet
from recman_tpu_torch import layers
from recman_tpu_torch.utils import JaxKey, glorot_normal
from tests.test_torch_zoo_cross import (
    ROUTES,
    check_init_from_jax_key,
    check_layer,
    check_model,
    jax_l2,
    layer_grads_match,
    _jnp,
    _tt,
)
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

MODELS = ("autoint", "fibinet", "masknet", "final_mlp")


@pytest.mark.parametrize("schema", ["synthetic", "criteo"])
@pytest.mark.parametrize("name", MODELS)
def test_init_from_jax_key_matches_jax(name, schema, synthetic_df):
    check_init_from_jax_key(name, schema, synthetic_df)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("schema", ["synthetic", "criteo"])
@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(name, schema, route, synthetic_df):
    """Each of the four at its defaults: AutoInt with its residual, linear
    tower and (Criteo) numeric-field embeddings, FiBiNET "all", MaskNet
    parallel, FinalMLP context-free."""
    r, _ = check_model(name, None, schema, route, synthetic_df)
    if name == "autoint":
        assert ("autoint_dense_embed" in r["np_params"]) == (r["tm"].n_dense > 0)


VARIANTS = {
    "autoint-no-residual": ("autoint", {"att_use_residual": False}),
    "autoint-no-linear": ("autoint", {"use_linear": False}),
    "fibinet-each": ("fibinet", {"bilinear_type": "each"}),
    "fibinet-interaction": ("fibinet", {"bilinear_type": "interaction"}),
    "masknet-serial": ("masknet", {"variant": "serial"}),
    # context-aware gates: stream 1 on the user's fields, stream 2 on the
    # item's, the sequence feature giving its max_len slots
    "final_mlp-context": ("final_mlp", {"fs1_context": ("USER_ID", "HISTORICAL_CATEGORIES"),
                                        "fs2_context": ("CLASS_ID", "SEQUENCE_VAL_1")}),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax(variant, route, synthetic_df):
    """Without the residual, the attention of the last layer saturates: the
    gradients of its query and key projections are about 1e-12 against
    0.4 for the largest leaf, cancellation noise in both packages, and
    held to 1e-5 of the largest."""
    name, hp = VARIANTS[variant]
    noise = ("autoint_2_wq", "autoint_2_wk") if variant == "autoint-no-residual" else ()
    r, _ = check_model(name, hp, "synthetic", route, synthetic_df, noise)
    tm, names = r["tm"], set(r["np_params"])
    if variant == "autoint-no-residual":
        assert not any(n.endswith("_wres") for n in names)
    elif variant == "autoint-no-linear":
        assert not hasattr(tm, "packed") and "linear_w" not in names
    elif variant == "masknet-serial":
        assert tm.head_dnn is None and "masknet_out_w" in names
    elif variant == "final_mlp-context":
        # USER_ID is slot 0, HISTORICAL_CATEGORIES slot 4; CLASS_ID slot 1,
        # the sequence's three slots after MULTI_VAL_1
        assert tm._ctx_slots1 == (0, 4) and tm._ctx_slots2 == (1, 6, 7, 8)
        assert "final_fs1_ctx" not in names and "final_fs2_ctx" not in names


# -- the layers ------------------------------------------------------------------

def _embeds(seed, b=6, f=5, k=4):
    return np.random.RandomState(seed).randn(b, f, k).astype(np.float32)


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no-residual"])
def test_interacting_layer_matches_jax(residual):
    """Attention across fields, unscaled; without the residual the keys
    are still taken 4 a layer, so layer 1 starts at key 3 of the split."""
    kw = dict(num_layers=2, num_heads=2, head_size=3, use_residual=residual, l2_reg=0.1)
    jl, tl = jax_layers.InteractingLayer(4, **kw), layers.InteractingLayer(4, **kw)
    np_params = check_layer(jl, tl, 21, [_embeds(22)],
                            lambda l, p, a: l.apply(p, a, training=False))
    assert abs(float(tl.l2(_tt(np_params))) - jax_l2(jl, np_params)) <= 1e-6
    if not residual:  # layer 1's wq is key 3 of the 8
        key3 = JaxKey(21).split(8)[3]
        torch.testing.assert_close(tl.init(JaxKey(21))["autoint_1_wq"],
                                   glorot_normal(key3, (6, 6)), rtol=0, atol=0)
    # no 1/sqrt(dh): scaling q by sqrt(dh) changes the output
    p = _tt(np_params)
    x = torch.as_tensor(_embeds(22))
    scaled = dict(p, autoint_0_wq=p["autoint_0_wq"] / np.sqrt(3.0))
    assert not torch.allclose(tl.apply(p, x), tl.apply(scaled, x))


def test_senet_layer_matches_jax():
    f = 7
    jl, tl = jax_senet.SENETLayer(f, 3, l2_reg=0.2), layers.SENETLayer(f, 3, l2_reg=0.2)
    assert tl.reduced == jl.reduced == 2
    np_params = check_layer(jl, tl, 23, [_embeds(24, f=f)], lambda l, p, a: l.apply(p, a))
    assert abs(float(tl.l2(_tt(np_params))) - jax_l2(jl, np_params)) <= 1e-6
    assert layers.SENETLayer(2, 3).reduced == 1


@pytest.mark.parametrize("kind", ["all", "each", "interaction"])
def test_bilinear_interaction_matches_jax(kind):
    """One (n_w, k, k) Glorot draw at the 3-D rule's fans; "each" indexes
    its weights by the pair's first field."""
    f, k = 5, 4
    jl = jax_senet.BilinearInteraction(f, k, kind, l2_reg=0.3)
    tl = layers.BilinearInteraction(f, k, kind, l2_reg=0.3)
    assert tl.output_dim == jl.output_dim == 10 * k
    np_params = check_layer(jl, tl, 25, [_embeds(26, f=f, k=k)], lambda l, p, a: l.apply(p, a))
    w = np_params[f"bilinear_w_{kind}"]
    assert w.shape == ({"all": 1, "each": f, "interaction": 10}[kind], k, k)
    if kind == "each":  # pair 4 is (1, 2): W_1
        e = _embeds(26, f=f, k=k)
        got = tl.apply(_tt(np_params), torch.as_tensor(e)).numpy()
        np.testing.assert_allclose(got[:, 4], (e[:, 1] @ w[1]) * e[:, 2], rtol=0, atol=1e-5)
    assert abs(float(tl.l2(_tt(np_params))) - jax_l2(jl, np_params)) <= 1e-6


def test_mask_block_matches_jax():
    jl = jax_masknet.MaskBlock(12, 9, 6, 5, l2_reg=0.1, prefix="mb_")
    tl = layers.MaskBlock(12, 9, 6, 5, l2_reg=0.1, prefix="mb_")
    rs = np.random.RandomState(27)
    x, v = rs.randn(4, 9).astype(np.float32), rs.randn(4, 12).astype(np.float32)
    np_params = check_layer(jl, tl, 27, [x, v], lambda l, p, a, b: l.apply(p, a, b),
                            randomize=["mb_agg_b", "mb_proj_b", "mb_ln_beta"])
    assert abs(float(tl.l2(_tt(np_params))) - jax_l2(jl, np_params)) <= 1e-6
    assert tl.l2(_tt(np_params)) != 0.0 and layers.MaskBlock(12, 9, 6, 5).l2({}) == 0.0


def test_mlp_block_matches_jax():
    kw = dict(hidden_units=(6, 5), dropout_keep=(1.0, 1.0), activation="relu", l2_reg=0.2)
    jl, tl = jax_layers.MLPBlock(7, **kw), layers.MLPBlock(7, **kw)
    x = np.random.RandomState(28).randn(4, 7).astype(np.float32)
    np_params = check_layer(jl, tl, 28, [x], lambda l, p, a: l.apply(p, a, training=False),
                            randomize=["mlp_layer_0_bias", "mlp_layer_1_bias"])
    assert tl.output_dim == 5
    assert abs(float(tl.l2(_tt(np_params))) - jax_l2(jl, np_params)) <= 1e-6
    with pytest.raises(AssertionError, match="per hidden layer"):
        layers.MLPBlock(7, (6, 5), (1.0, 1.0, 1.0), "relu")


@pytest.mark.parametrize("context_free", [True, False], ids=["context-free", "context-aware"])
def test_feature_selection_gate_matches_jax(context_free):
    """2 / (1 + exp(-x)); the context vector drawn as 0.01 * Glorot."""
    jl = jax_layers.FeatureSelectionGate(8, 3, 5, context_free, l2_reg=0.1)
    tl = layers.FeatureSelectionGate(8, 3, 5, context_free, l2_reg=0.1)
    rs = np.random.RandomState(29)
    flat, ctx = rs.randn(4, 8).astype(np.float32), rs.randn(4, 3).astype(np.float32)
    if context_free:
        np_params = check_layer(jl, tl, 29, [flat], lambda l, p, a: l.apply(p, a),
                                randomize=["fs_gate_b1", "fs_gate_b2"])
        assert np_params["fs_ctx"].shape == (1, 3) and np.abs(np_params["fs_ctx"]).max() < 0.02
    else:
        np_params = check_layer(jl, tl, 29, [flat, ctx], lambda l, p, a, c: l.apply(p, a, c),
                                randomize=["fs_gate_b1", "fs_gate_b2"])
        assert "fs_ctx" not in np_params
    gate = tl.gate(_tt(np_params), None if context_free else torch.as_tensor(ctx))
    assert bool(((gate > 0) & (gate < 2)).all())
    assert abs(float(tl.l2(_tt(np_params))) - jax_l2(jl, np_params)) <= 1e-6


def test_interaction_aggregation_matches_jax():
    jl = jax_layers.InteractionAggregation(8, 6, num_heads=2, l2_reg=0.1)
    tl = layers.InteractionAggregation(8, 6, num_heads=2, l2_reg=0.1)
    rs = np.random.RandomState(30)
    o1, o2 = rs.randn(4, 8).astype(np.float32), rs.randn(4, 6).astype(np.float32)
    np_params = check_layer(jl, tl, 30, [o1, o2], lambda l, p, a, b: l.apply(p, a, b),
                            randomize=["agg_bias"])
    assert np_params["agg_w12"].shape == (2, 4, 3)
    assert abs(float(tl.l2(_tt(np_params))) - jax_l2(jl, np_params)) <= 1e-6
    # the heads must split both dims, as in JAX
    for pkg in (jax_layers, layers):
        with pytest.raises(AssertionError, match="must divide num_heads=4"):
            pkg.InteractionAggregation(8, 6, num_heads=4)


def test_layer_norm_and_gate_round_as_jax():
    """MaskNet's LayerNorm (eps 1e-6, population variance) and the gate's
    2 / (1 + exp(-x)) on large inputs, against JAX's."""
    x = (np.random.RandomState(31).randn(5, 6) * 40).astype(np.float32)
    jn, tn = jax_masknet.LayerNorm(6, prefix="n_"), layers.LayerNorm(6, prefix="n_")
    p = {k: np.asarray(v) for k, v in jn.init().items()}
    layer_grads_match(lambda a: jn.apply(_jnp(p), a), lambda a: tn.apply(_tt(p), a), [x])
    ref = np.asarray(2.0 * jnp.reciprocal(1.0 + jnp.exp(-jnp.asarray(x / 10))))
    got = (2.0 * torch.reciprocal(1.0 + torch.exp(-torch.as_tensor(x / 10)))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.4e-7)
    assert jax_autoint.InteractingLayer(4).output_dim == layers.InteractingLayer(4).output_dim
