"""The port's last public names against the JAX package's: the version,
the schema's JSON re-exported at the top level, and the He initializers.

The initializers on a ``utils.JaxKey`` draw what ``jax.random`` draws from
the same key, within 2.4e-7 (the known ``JaxKey`` bound: the truncated
normal's ``erf_inv`` is 1 ulp off on some draws); on a ``torch.Generator``
they keep to their bounds (±2σ, ±b).
"""

from __future__ import annotations

import math

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import recman_tpu
import recman_tpu_torch
from recman_tpu.data import create_criteo_features as j_criteo_features
from recman_tpu.data import create_ml_features as j_ml_features
from recman_tpu.data import get_ml_dataset as j_ml_dataset
from recman_tpu.utils import he_normal as j_he_normal
from recman_tpu.utils import he_uniform as j_he_uniform
from recman_tpu_torch import utils
from recman_tpu_torch.data import concat_rows, create_criteo_features, create_ml_features
from recman_tpu_torch.data import get_ml_dataset
from recman_tpu_torch.utils import JaxKey, he_normal, he_uniform
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

JAXKEY_TOL = 2.4e-7
SHAPES = [(30, 20), (3, 3, 8, 16)]


def test_version_is_the_reference_s():
    assert recman_tpu_torch.__version__ == recman_tpu.__version__ == "0.1.0"


def test_schema_json_is_re_exported():
    from recman_tpu_torch import features

    assert recman_tpu_torch.schema_to_json is features.schema_to_json
    assert recman_tpu_torch.schema_from_json is features.schema_from_json


def _schemas(which):
    if which == "criteo":
        return create_criteo_features(num_buckets=1000), j_criteo_features(num_buckets=1000)
    train, valid, _, domains = get_ml_dataset(frac=0.5, random_seed=2019)
    jtrain, jvalid, _, jdomains = j_ml_dataset(frac=0.5, random_seed=2019)
    return (create_ml_features(concat_rows(train, valid), domains),
            j_ml_features(pd.concat([jtrain, jvalid]), jdomains))


def _hashed_only(fs, feature_set):
    """The schema's features but its dense ones, whose log1p scaler has no
    JSON form."""
    out = feature_set()
    for name, feat in fs.items():
        if type(feat).__name__ != "DenseFeat":
            out[name] = feat
    return out


def test_criteo_dense_scaler_has_no_json_in_either_package():
    port, ref = _schemas("criteo")
    with pytest.raises(TypeError, match="_Log1pScaler is not JSON-serializable") as got:
        recman_tpu_torch.schema_to_json(port)
    with pytest.raises(TypeError) as want:
        recman_tpu.schema_to_json(ref)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("which", ["criteo", "ml_100k"])
def test_schema_json_is_the_reference_s_and_round_trips(which):
    port, ref = _schemas(which)
    if which == "criteo":
        port = _hashed_only(port, recman_tpu_torch.FeatureSet)
        ref = _hashed_only(ref, recman_tpu.FeatureSet)
    text = recman_tpu_torch.schema_to_json(port)
    assert text == recman_tpu.schema_to_json(ref)
    back = recman_tpu_torch.schema_from_json(text)
    assert list(back) == list(port)
    assert recman_tpu_torch.schema_to_json(back) == text


def test_he_initializers_are_exported():
    assert {"he_normal", "he_uniform"} <= set(utils.__all__)
    assert utils.he_normal is he_normal and utils.he_uniform is he_uniform


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("port_fn,jax_fn", [(he_normal, j_he_normal), (he_uniform, j_he_uniform)])
def test_he_on_a_jaxkey_draws_jax_s_values(shape, port_fn, jax_fn):
    got = port_fn(JaxKey(7), shape, device="cpu").numpy()
    want = np.asarray(jax_fn(jax.random.PRNGKey(7), shape))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=JAXKEY_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_he_on_a_generator_keeps_its_bounds(shape):
    fan_in = recman_tpu_torch.utils.calc_fan(shape)[0]
    sigma, b = math.sqrt(2.0 / fan_in), math.sqrt(6.0 / fan_in)
    n = he_normal(torch.Generator().manual_seed(3), shape, device="cpu")
    u = he_uniform(torch.Generator().manual_seed(3), shape, device="cpu")
    assert n.shape == u.shape == shape and n.dtype == u.dtype == torch.float32
    assert float(n.abs().max()) <= 2 * sigma and float(u.abs().max()) <= b
    # the draws spread over their range, not a constant
    assert float(n.std()) > 0.5 * sigma and float(u.abs().max()) > 0.5 * b
    again = he_normal(torch.Generator().manual_seed(3), shape, device="cpu")
    assert torch.equal(n, again)


def test_initializers_on_the_meta_device_draw_nothing():
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    for fn in (he_normal, he_uniform, utils.glorot_normal, utils.glorot_uniform):
        t = fn(g, (4, 5), device="meta")
        assert t.device.type == "meta" and t.shape == (4, 5)
    assert torch.equal(g.get_state(), state)
