"""The port's xDeepFM serving slice (recman_tpu_torch) against the JAX
package on the CPU: the same params (carried over by
``convert.params_from_jax``) and the same rows give the same predictions.

Tolerance for predictions: 1e-5. The JAX CPU path is the batch-major
einsum with bf16 z and W and f32 sums; the port's CPU path rounds at the
same places, so only the order of f32 sums differs (measured about 1e-7).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import recman_tpu
import recman_tpu_torch
from recman_tpu.models import XDeepFM as JaxXDeepFM
from recman_tpu.serving import Predictor as JaxPredictor
from recman_tpu.training.trainer import batch_indices as jax_batch_indices
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.serving import Predictor, batch_indices
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
PRED_TOL = 1e-5


def _schema(pkg, df, max_len=3):
    """Every feature type on the reference's 16-row synthetic dataframe,
    built with one package's own schema classes."""
    fs = pkg.FeatureSet()
    user = pkg.SparseFeat("USER_ID")
    item = pkg.SparseFeat("CLASS_ID")
    fs["USER_ID"] = user
    fs["CLASS_ID"] = item
    fs["CATEGORY"] = pkg.SparseFeat("CATEGORY")
    fs["CATEGORY_COUNT"] = pkg.SparseValueFeat("CATEGORY_COUNT")
    fs["TIMESTAMP"] = pkg.DenseFeat("TIMESTAMP")
    fs["HISTORICAL_CATEGORIES"] = pkg.MultiValCsvFeat(
        "HISTORICAL_CATEGORIES", tags=("a", "b", "c", "d")
    )
    fs["MULTI_VAL_1"] = pkg.MultiValSparseFeat("MULTI_VAL_1", max_len=max_len)
    fs["SEQUENCE_VAL_1"] = pkg.SequenceFeat("SEQUENCE_VAL_1", id_feat=item, max_len=max_len)
    fs.initialize(df)
    return fs


def _shared_params(jax_model, seed=0):
    """JAX init params as numpy, with the zero-initialised vectors (linear
    weights, biases) given random values so every term takes part."""
    rs = np.random.RandomState(seed)
    params = {k: np.asarray(v) for k, v in jax_model.init_params(jax.random.PRNGKey(0)).items()}
    for k, v in params.items():
        if not v.any():
            params[k] = (0.3 * rs.randn(*v.shape)).astype(np.float32)
    return params


def _pair(df, hparams=None):
    jm = JaxXDeepFM(_schema(recman_tpu, df), hparams)
    tm = XDeepFM(_schema(recman_tpu_torch, df), hparams)
    np_params = _shared_params(jm)
    return jm, tm, np_params


def _jax_preds(model, np_params, batch):
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    return np.asarray(
        model.apply(params, {k: jnp.asarray(v) for k, v in batch.items()}, training=False)
    )


def _torch_preds(model, np_params, batch):
    params = params_from_jax(np_params, device="cpu")
    with torch.inference_mode():
        out = model.apply(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    return out.numpy()


class TestModelParity:
    def test_param_names_and_shapes_match_jax(self, synthetic_df):
        jm, tm, np_params = _pair(synthetic_df)
        tparams = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
        assert {k: tuple(v.shape) for k, v in tparams.items()} == \
            {k: v.shape for k, v in np_params.items()}
        assert all(v.dtype == torch.float32 for v in tparams.values())

    def test_synthetic_all_feature_types(self, synthetic_df):
        jm, tm, np_params = _pair(synthetic_df)
        batch = tm.feat_dict.transform(synthetic_df)
        ref = _jax_preds(jm, np_params, batch)
        got = _torch_preds(tm, np_params, batch)
        assert got.shape == (16,)
        assert np.abs(ref - got).max() <= PRED_TOL

    def test_synthetic_batch_major_geometry(self, synthetic_df):
        # D = 10 is outside the chain's tiles: the port's CPU path takes the
        # per-layer path (K4's twin), the reference's CPU path the
        # batch-major einsum, with the same roundings
        hp = {"embedding_size": 10}
        jm, tm, np_params = _pair(synthetic_df, hp)
        batch = tm.feat_dict.transform(synthetic_df)
        assert np.abs(_jax_preds(jm, np_params, batch)
                      - _torch_preds(tm, np_params, batch)).max() <= PRED_TOL

    def test_narrow_criteo(self):
        from recman_tpu.data import create_criteo_features as jax_criteo
        from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays

        hp = {
            "embedding_size": 16,
            "cin_cross_layer_units": (8, 6),
            "cin_dropout": (1, 1, 1),
            "deep_hidden_units": (32, 32),
            "deep_dropout": (1.0, 1.0, 1.0),
        }
        jm = JaxXDeepFM(jax_criteo(num_buckets=1000), hp)
        tm = XDeepFM(create_criteo_features(num_buckets=1000), hp)
        np_params = _shared_params(jm, seed=1)
        batch = synthetic_criteo_arrays(64, num_buckets=1000, seed=7)
        batch.pop("y")
        ref = _jax_preds(jm, np_params, batch)
        got = _torch_preds(tm, np_params, batch)
        assert np.abs(ref - got).max() <= PRED_TOL

    def test_wide_cin_criteo_forward_and_loss(self):
        """``xdeepfm_wide_cin_criteo``, the bench model with its CIN set to
        (256, 256, 256) (every fan-in 128), cut to 1,000 buckets and 64
        rows: predictions and the training loss against JAX's, both CINs
        on their chains (the reference's Pallas kernels interpreted, the
        port's K1 and K2 twins)."""
        from recman_tpu.data import create_criteo_features as jax_criteo
        from recman_tpu.ops import cin_interact as jax_ci
        from recman_tpu.ops import embedding as jax_emb
        from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays

        hp = {"embedding_size": 16, "cin_cross_layer_units": (256, 256, 256),
              "cin_dropout": (1, 1, 1, 1), "deep_hidden_units": (400, 400),
              "deep_dropout": (1.0, 1.0, 1.0)}
        jm = JaxXDeepFM(jax_criteo(num_buckets=1000), hp)
        tm = XDeepFM(create_criteo_features(num_buckets=1000), hp)
        assert jm.cin._chain_eligible(True, 64, 16) and tm.cin._chain_eligible(True, 64, 16)
        np_params = _shared_params(jm, seed=4)
        batch = synthetic_criteo_arrays(64, num_buckets=1000, seed=8)
        params = params_from_jax(np_params, device="cpu")
        jp = {k: jnp.asarray(v) for k, v in np_params.items()}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        with jax_emb.fused_grad(True), jax_ci.pallas_cin(True):
            ref = np.asarray(jm.apply(jp, jb, training=False))
            ref_loss = float(jm.loss(jp, jb, training=True, rng=jax.random.PRNGKey(1)))
        with torch.no_grad():
            got = tm.apply(params, tb).numpy()
            loss = float(tm.loss(params, tb, training=True,
                                 generator=torch.Generator().manual_seed(1)))
        assert np.abs(ref - got).max() <= PRED_TOL
        assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)

    def test_linear_override_matches_jax(self, synthetic_df):
        jm, tm, np_params = _pair(synthetic_df)
        for model in (jm, tm):
            model.feat_dict["CATEGORY"].set_weights({"Outdoor": -5.0})
        batch = tm.feat_dict.transform(synthetic_df)
        ov = jm.linear.override_vector()
        np.testing.assert_array_equal(ov, tm.linear.override_vector())
        params = {k: jnp.asarray(v) for k, v in np_params.items()}
        ref = np.asarray(jm.apply(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                  training=False, linear_override=jnp.asarray(ov)))
        got = tm.apply(params_from_jax(np_params, device="cpu"),
                       {k: torch.as_tensor(v) for k, v in batch.items()},
                       linear_override=torch.as_tensor(ov)).numpy()
        assert np.abs(ref - got).max() <= PRED_TOL


class TestServingParity:
    def test_predict_and_override_rerank(self, synthetic_df):
        jm, tm, np_params = _pair(synthetic_df)
        jp = JaxPredictor(jm, {k: jnp.asarray(v) for k, v in np_params.items()}, batch_size=6)
        tp = Predictor(tm, params_from_jax(np_params, device="cpu"), batch_size=6, device="cpu")
        base_j, base_t = jp.predict(synthetic_df), tp.predict(synthetic_df)
        assert base_t.shape == (16,)
        assert np.abs(base_j - base_t).max() <= PRED_TOL

        for model in (jm, tm):
            model.feat_dict["CATEGORY"].set_weights({"Outdoor": -5.0})
        pen_j, pen_t = jp.predict(synthetic_df), tp.predict(synthetic_df)
        assert np.abs(pen_j - pen_t).max() <= PRED_TOL
        outdoor = (synthetic_df["CATEGORY"] == "Outdoor").values
        assert (pen_t[outdoor] < base_t[outdoor]).all()
        np.testing.assert_array_equal(pen_t[~outdoor], base_t[~outdoor])
        ignored = tp.predict(synthetic_df, apply_overrides=False)
        np.testing.assert_array_equal(ignored, base_t)

    def test_encoded_arrays_with_padding_batches(self):
        from recman_tpu.data import create_criteo_features as jax_criteo
        from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays

        hp = {"embedding_size": 16, "cin_cross_layer_units": (8, 6),
              "cin_dropout": (1, 1, 1), "deep_hidden_units": (32, 32)}
        jm = JaxXDeepFM(jax_criteo(num_buckets=500), hp)
        tm = XDeepFM(create_criteo_features(num_buckets=500), hp)
        np_params = _shared_params(jm, seed=2)
        data = synthetic_criteo_arrays(128, num_buckets=500, seed=3)  # 2 full + 1 padding batch
        ref = JaxPredictor(jm, {k: jnp.asarray(v) for k, v in np_params.items()},
                           batch_size=64).predict(data)
        got = Predictor(tm, params_from_jax(np_params, device="cpu"), batch_size=64,
                        device="cpu").predict(data)
        assert got.shape == (128,)
        assert np.abs(ref - got).max() <= PRED_TOL


@pytest.mark.parametrize("n,bs", [(16, 6), (128, 64), (5, 8), (0, 4)])
def test_batch_indices_match_jax(n, bs):
    np.testing.assert_array_equal(batch_indices(n, bs), jax_batch_indices(n, bs))


class TestInit:
    def test_glorot_normal_truncated_at_two_sigma(self):
        from recman_tpu.utils import glorot_normal as jax_glorot_normal
        from recman_tpu_torch.utils import glorot_normal

        shape = (400, 600)
        sigma = np.sqrt(2.0 / sum(shape))
        t = glorot_normal(torch.Generator().manual_seed(0), shape).numpy()
        j = np.asarray(jax_glorot_normal(jax.random.PRNGKey(0), shape))
        assert t.shape == shape and t.dtype == np.float32
        assert np.abs(t).max() <= 2 * sigma * (1 + 1e-6)
        assert abs(t.mean()) < 0.01 * sigma
        # a normal truncated at ±2σ has std 0.8796σ; 240k draws pin it to ~0.3%
        assert abs(t.std() / sigma - 0.8796) < 0.01
        assert abs(t.std() - j.std()) < 0.01 * sigma

    def test_glorot_uniform_bounds(self):
        from recman_tpu_torch.utils import glorot_uniform

        shape = (300, 1)
        b = np.sqrt(6.0 / sum(shape))
        t = glorot_uniform(torch.Generator().manual_seed(1), shape).numpy()
        assert np.abs(t).max() <= b and abs(t.std() / (b / np.sqrt(3)) - 1) < 0.1

    def test_init_is_reproducible_from_the_seed(self, synthetic_df):
        tm = XDeepFM(_schema(recman_tpu_torch, synthetic_df))
        a = tm.init_params(torch.Generator().manual_seed(3), device="cpu")
        b = tm.init_params(torch.Generator().manual_seed(3), device="cpu")
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_leaky_relu_slope_is_point_two():
    from recman_tpu_torch.layers import leaky_relu

    x = torch.tensor([-1.0, 0.0, 2.0])
    np.testing.assert_allclose(leaky_relu(x).numpy(), [-0.2, 0.0, 2.0])


class TestScope:
    def test_default_device_raises_without_gpu(self, synthetic_df):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        tm = XDeepFM(_schema(recman_tpu_torch, synthetic_df))
        params = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Predictor(tm, params)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tm.init_params(torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            params_from_jax({"x": np.zeros(2, np.float32)})

    def test_training_raises(self, synthetic_df):
        """Training is ported with the reference's whole optimizer menu
        (tests/test_torch_optim.py holds each to optax); a name outside it
        raises, as in the reference."""
        from recman_tpu_torch.training import create_optimizer

        for name in ("adam", "adam_bf16m", "adagrad", "gd", "sgd", "momentum", "lamb",
                     "rowwise_adam"):
            assert hasattr(create_optimizer(name, 1e-3), "update")
        with pytest.raises(ValueError, match="unknown optimizer"):
            create_optimizer("adadelta", 1e-3)

    def test_training_mode_with_unit_keeps_matches_eval(self, synthetic_df):
        """With every keep at 1, training=True gives the predictions of
        training=False (the reference's
        test_training_mode_with_unit_keeps_matches_eval_routing); the
        override is ignored in training, so none is passed."""
        tm = XDeepFM(_schema(recman_tpu_torch, synthetic_df),
                     {"deep_dropout": (1.0, 1.0, 1.0)})
        params = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in tm.feat_dict.transform(synthetic_df).items()}
        gen = torch.Generator().manual_seed(1)
        train = tm.apply(params, batch, training=True, generator=gen)
        with torch.inference_mode():
            served = tm.apply(params, batch, training=False)
        assert train.shape == (16,)
        torch.testing.assert_close(train.detach(), served, rtol=0, atol=0)

    def test_unported_options_raise(self, synthetic_df):
        # QR embeddings are ported: the reference's param names, and its
        # NotImplementedError for a multi-valued feature
        params = {}
        for pkg, key in ((recman_tpu, jax.random.PRNGKey(0)),
                         (recman_tpu_torch, recman_tpu_torch.utils.JaxKey(0))):
            fs = pkg.FeatureSet()
            fs["u"] = pkg.SparseFeat("u", feat_size=10, qr_collisions=3)
            model = (JaxXDeepFM if pkg is recman_tpu else XDeepFM)(fs)
            params[pkg.__name__] = list(model.init_params(key, **(
                {"device": "cpu"} if pkg is recman_tpu_torch else {})))
        assert params["recman_tpu_torch"] == params["recman_tpu"]
        assert "u_feat_embed_q" in params["recman_tpu_torch"]
        fs = recman_tpu_torch.FeatureSet()
        fs["m"] = recman_tpu_torch.MultiValSparseFeat("m", max_len=3)
        fs["m"].qr_collisions = 3
        fs.initialize(pd.DataFrame({"m": [["a", "b"], ["c"]]}))
        with pytest.raises(NotImplementedError, match="single-id"):
            XDeepFM(fs).init_params(torch.Generator().manual_seed(0), device="cpu")
        # Dice is ported: xDeepFM's DNN takes it, with the reference's
        # params and its eval forward on the stored moments
        jm, tm, np_params = _pair(synthetic_df, {"deep_activation": "dice"})
        own = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
        assert list(own) == list(np_params) and "dnn_dice_mean_0" in own
        batch = tm.feat_dict.transform(synthetic_df)
        np.testing.assert_allclose(_torch_preds(tm, np_params, batch),
                                   _jax_preds(jm, np_params, batch), rtol=0, atol=PRED_TOL)


def _port_files():
    return sorted((REPO / "recman_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    # nor the JAX package's root bench scripts and tools
    banned = ("jax", "recman_tpu", "bench", "bench_scaling", "tools")
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in banned, f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import recman_tpu_torch\n"
        "for m in pkgutil.walk_packages(recman_tpu_torch.__path__, 'recman_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'recman_tpu')\n"
        "bad += sorted(m for m in new if m.split('.')[0] == 'jax')\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


COPIED = [
    "features/__init__.py", "features/encoders.py", "features/schema.py",
    "features/serialize.py", "config/__init__.py", "config/hparams.py",
    "data/criteo.py", "training/metrics.py", "obs/__init__.py", "obs/best_model.py",
    "ckpt/transfer.py", "training/resilient.py", "data/streaming.py", "parallel/traffic.py",
]


@pytest.mark.parametrize("rel", COPIED)
def test_host_module_copies_match_the_reference(rel):
    """The port keeps its own copies of the numpy-only host modules; they
    must not drift from the reference."""
    assert (REPO / "recman_tpu_torch" / rel).read_bytes() == \
        (REPO / "recman_tpu" / rel).read_bytes()


# the port's native loader is the reference's but for where it caches the
# built parser: under the checkout's build/native/, not a path shared by
# every checkout on the host
NATIVE_LOADER_CHANGES = [
    ("this image; plain C ABI + ctypes) and cached next to the source with a\n"
     "content-hash suffix so source edits rebuild automatically.\n",
     "this image; plain C ABI + ctypes) and cached under build/native/ at the\n"
     "checkout's root with a content-hash suffix so source edits rebuild\n"
     "automatically.\n"),
    ('    out = os.path.join("/tmp", f"libcriteo_parser_{tag}.so")\n',
     '    out = os.path.join(os.path.dirname(os.path.dirname(_SRC)), "build", "native",\n'
     '                       f"libcriteo_parser_{tag}.so")\n'
     '    os.makedirs(os.path.dirname(out), exist_ok=True)\n'),
]


def test_native_loader_differs_from_the_reference_only_in_its_build_dir():
    want = (REPO / "recman_tpu" / "data" / "native_loader.py").read_text()
    for old, new in NATIVE_LOADER_CHANGES:
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    assert (REPO / "recman_tpu_torch" / "data" / "native_loader.py").read_text() == want
