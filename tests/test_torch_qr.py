"""QR compositional embeddings in the port (``recman_tpu_torch.layers.
embedding``) against the JAX package on the CPU, case by case as
``tests/test_qr_embedding.py``: quotient + remainder tables replace a full
(V, k) table for single-id sparse features, each id keeping a unique
composed vector Q[id // q] + R[id % q]. Also ``utils.split_train_test``
against pandas and ``examples.xdeepfm_synthetic`` against the reference's
example.

Tolerances are the zoo's (tests/test_torch_zoo.py): eval predictions 1e-5
absolute, the training loss 1e-6 relative, every gradient 1e-5 of its
leaf's max|ref| on both routes of the lookups' backward (the K6 twin
under "segmat", ``index_add_`` under "scatter"), ``Trainer.fit`` at lr
1e-3 within 1e-4; ``JaxKey`` params within 2 float32 ulps of 1.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import recman_tpu
import recman_tpu_torch
from recman_tpu.examples import xdeepfm_synthetic as jax_synthetic
from recman_tpu.models import MODEL_REGISTRY as JAX_MODELS
from recman_tpu.ops import cin_interact as jax_ci
from recman_tpu.ops import embedding as jax_emb
from recman_tpu.training import LogLoss as JaxLogLoss
from recman_tpu.training import Trainer as JaxTrainer
from recman_tpu.utils.numerics import split_train_test as jax_split
from recman_tpu_torch import models
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.examples import xdeepfm_synthetic
from recman_tpu_torch.ops import embedding as torch_emb
from recman_tpu_torch.training import LogLoss, Trainer, init_state
from recman_tpu_torch.training.train_step import loss_and_grads
from recman_tpu_torch.utils import JaxKey, split_train_test
from tests.test_torch_zoo import FIT_LOSS_REL, FIT_PRED_ABS, GRAD_TOL, LOSS_REL, PRED_TOL, ULPS
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

HP = {"embedding_size": 4, "deep_hidden_units": (8,), "deep_dropout": (1.0, 1.0)}
HP_CIN = {**HP, "cin_cross_layer_units": (4, 4), "cin_dropout": (1, 1, 1)}
ROUTES = ("segmat", "scatter")


def _qr_df(n_rows=64, vocab=97, seed=0):
    rs = np.random.RandomState(seed)
    df = pd.DataFrame({
        "u": [f"u{i}" for i in rs.randint(0, vocab, n_rows)],
        "h": [f"h{i}" for i in rs.randint(0, 1000, n_rows)],
        "d": rs.randn(n_rows),
    })
    return df, rs.randint(0, 2, n_rows).astype(np.float32)


def _qr_schema(pkg, df, q=10):
    """The reference test's schema: a QR sparse feature (q 10), a QR hashed
    one (200 buckets, q 15) and a dense one."""
    fs = pkg.FeatureSet()
    fs["u"] = pkg.SparseFeat("u", qr_collisions=q)
    fs["h"] = pkg.HashedSparseFeat("h", num_buckets=200, qr_collisions=15)
    fs["d"] = pkg.DenseFeat("d")
    fs.initialize(df)
    return fs


def _pair(name, df, hp):
    jm = JAX_MODELS[name](_qr_schema(recman_tpu, df), hp)
    tm = models.model_class(name)(_qr_schema(recman_tpu_torch, df), hp)
    return jm, tm


@pytest.fixture(scope="module")
def qr_data():
    return _qr_df()


@pytest.mark.parametrize("name, hp", [("deepfm", HP), ("xdeepfm", HP_CIN)])
def test_params_match_jax(name, hp, qr_data):
    """The reference's names and shapes, and with a ``JaxKey`` its values:
    the two tables drawn in its key-split order; no full table; the bias
    (DeepFM's) full-size."""
    df, _ = qr_data
    jm, tm = _pair(name, df, hp)
    ref = {k: np.asarray(v) for k, v in jm.init_params(jax.random.PRNGKey(0)).items()}
    got = tm.init_params(JaxKey(0), device="cpu")
    assert list(got) == list(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=ULPS, atol=ULPS, err_msg=k)
    assert "u_feat_embed" not in got and "h_feat_embed" not in got
    v_u = tm.feat_dict["u"].feat_size
    assert got["u_feat_embed_q"].shape == (-(-v_u // 10), 4)
    assert got["u_feat_embed_r"].shape == (10, 4)
    assert got["h_feat_embed_q"].shape == (-(-201 // 15), 4)
    if "u_feat_bias" in got:
        assert got["u_feat_bias"].shape == (v_u,)
    own = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in ref.items()}


def test_memory_and_unique_composition(qr_data):
    """(V/q + q) rows instead of V: under half the full table; rows equal
    Q[id // q] + R[id % q] exactly, and ids sharing a quotient or a
    remainder still compose distinct vectors."""
    df, _ = qr_data
    _, tm = _pair("deepfm", df, HP)
    params = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    full = tm.feat_dict["u"].feat_size * 4
    assert params["u_feat_embed_q"].numel() + params["u_feat_embed_r"].numel() < full / 2
    ids = torch.arange(30)
    rows = tm.embeddings._qr_rows(params, tm.feat_dict["u"], ids).numpy()
    tq, tr = params["u_feat_embed_q"].numpy(), params["u_feat_embed_r"].numpy()
    np.testing.assert_array_equal(rows, tq[np.arange(30) // 10] + tr[np.arange(30) % 10])
    assert len({tuple(np.round(r, 6)) for r in rows}) == 30


@pytest.mark.parametrize("name, hp", [("deepfm", HP), ("xdeepfm", HP_CIN)])
def test_model_matches_jax(name, hp, qr_data):
    """Eval predictions, the training loss and every gradient against JAX
    from JAX's params, on both routes of the lookups' backward, each
    package on its kernels' path (JAX's Pallas kernels interpreted, the
    port's twins)."""
    df, y = qr_data
    jm, tm = _pair(name, df, hp)
    rs = np.random.RandomState(1)
    np_params = {k: np.asarray(v) for k, v in jm.init_params(jax.random.PRNGKey(0)).items()}
    for k, v in np_params.items():  # every zero-initialised vector takes part
        if not v.any():
            np_params[k] = (0.3 * rs.randn(*v.shape)).astype(np.float32)
    params = params_from_jax(np_params, device="cpu")
    batch = tm.feat_dict.transform(df, y=y)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}

    ref = np.asarray(jm.apply(jparams, jbatch, training=False))
    with torch.inference_mode():
        got = tm.apply(params, tbatch).numpy()
    assert np.abs(ref - got).max() <= PRED_TOL

    for route in ROUTES:
        with jax_emb.fused_grad(True), jax_ci.pallas_cin(True), jax_emb.grad_kernel(route):
            ref_loss, ref_grads = jax.value_and_grad(
                lambda p: jm.loss(p, jbatch, training=True, rng=None))(jparams)
        with torch_emb.fused_grad(True), torch_emb.grad_kernel(route):
            loss, grads = loss_and_grads(tm, params, tbatch)
        assert abs(loss.item() - float(ref_loss)) <= LOSS_REL * abs(float(ref_loss))
        assert set(grads) == set(ref_grads)
        for k, g in ref_grads.items():
            g = np.asarray(g)
            scale = float(np.abs(g).max()) or 1.0
            err = float(np.abs(grads[k].numpy() - g).max())
            assert err <= GRAD_TOL * scale, f"{name} [{route}] {k}: {err} > {GRAD_TOL} * {scale}"


def test_fit_matches_jax_trainer():
    """Two epochs of DeepFM with QR fields on the kernels' route (the JAX
    Pallas kernels interpreted, the port's K6 twins), from the same params,
    at lr 1e-3."""
    df, y = _qr_df(n_rows=256)
    hp = {**HP, "learning_rate": 1e-3}
    jm, tm = _pair("deepfm", df, hp)
    jt = JaxTrainer(jm, hp, metrics=(JaxLogLoss(),), epoch=2, batch_size=32, random_seed=2019)
    with jax_emb.fused_grad(True), jax_emb.grad_kernel("segmat"):
        jt.fit(df, y, random_seed_for_mini_batch=False)
        ref_preds = jt.predict(df)
    tt = Trainer(tm, hp, metrics=(LogLoss(),), epoch=2, batch_size=32, device="cpu")
    tt.state = init_state(tm, tt.optimizer, JaxKey(2019), device="cpu")
    x = tm.feat_dict.transform(df)
    with torch_emb.fused_grad(True), torch_emb.grad_kernel("segmat"):
        tt.fit(x, y, random_seed_for_mini_batch=False)
        preds = tt.predict(x)
    assert abs(tt.last_mean_loss - jt.last_mean_loss) <= FIT_LOSS_REL * abs(jt.last_mean_loss)
    assert np.abs(preds - ref_preds).max() <= FIT_PRED_ABS


def test_schema_json_round_trip(qr_data):
    from recman_tpu_torch.features import schema_from_json, schema_to_json

    df, _ = qr_data
    fs = _qr_schema(recman_tpu_torch, df)
    text = schema_to_json(fs)
    assert text == recman_tpu.schema_to_json(_qr_schema(recman_tpu, df))
    fs2 = schema_from_json(text)
    assert fs2["u"].qr_collisions == 10 and fs2["h"].qr_collisions == 15
    a, b = fs.transform(df), fs2.transform(df)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_qr_rejected_for_multival_and_out_of_range():
    fs = recman_tpu_torch.FeatureSet()
    f = recman_tpu_torch.MultiValSparseFeat("m", max_len=3)
    f.qr_collisions = 4  # not a constructor arg; simulate misuse
    fs["m"] = f
    fs.initialize(pd.DataFrame({"m": [["a", "b"], ["c"]]}))
    model = models.DeepFM(fs, HP)
    with pytest.raises(NotImplementedError, match="single-id"):
        model.init_params(torch.Generator().manual_seed(0), device="cpu")
    fs = recman_tpu_torch.FeatureSet()
    fs["u"] = recman_tpu_torch.SparseFeat("u", feat_size=10, qr_collisions=1)
    with pytest.raises(ValueError, match=r"\(1, feat_size\)"):
        models.DeepFM(fs, HP).init_params(torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("n, frac", [(103, 0.8), (10, 0.5)])
def test_split_train_test_takes_pandas_rows(n, frac):
    """The rows, in order, of the reference's ``DataFrame.sample`` split,
    on a frame whose index is not its positions."""
    rs = np.random.RandomState(n)
    cols = {"a": np.arange(n), "b": rs.randn(n), "s": np.array([f"s{i}" for i in range(n)])}
    df = pd.DataFrame(cols, index=rs.permutation(n) * 3)
    for want, got in zip(jax_split(df, frac, 2019), split_train_test(cols, frac, 2019)):
        for k in cols:
            np.testing.assert_array_equal(got[k], want[k].values)


def _no_dropout(hparams_cls):
    class NoDropout(hparams_cls):
        def __init__(self):
            super().__init__()
            self[self.DeepDropOut]([(1.0, 1.0, 1.0)])
    return NoDropout


def test_xdeepfm_synthetic_matches_jax(tmp_path, monkeypatch):
    """``main`` against the reference's example from the seed-2019 params,
    with the DNN's dropout off in both (the two draw other masks): the
    predictions before and after the Outdoor override within 5e-3 and the
    same rankings where neighbours are 1e-2 apart. Five Adam steps at lr
    1e-2 carry f32 sum-order differences (1e-7) into lr-sized moves of
    params whose gradient is near 0 (ROADMAP.md's lr-1e-2 Adam trap); the
    spread measured is 1.2e-3. Every Outdoor row falls after the
    override."""
    monkeypatch.setattr(xdeepfm_synthetic, "HyperParams",
                        _no_dropout(xdeepfm_synthetic.HyperParams))
    monkeypatch.setattr(jax_synthetic, "HyperParams", _no_dropout(jax_synthetic.HyperParams))
    monkeypatch.setattr(jax_synthetic, "TB_LOG_DIR", str(tmp_path / "jax_logs"))
    cols, preds, penalized = xdeepfm_synthetic.main(device="cpu", log_dir=str(tmp_path / "logs"))
    ref = jax_synthetic.main()
    for got, want in ((preds, ref["PRED"].values), (penalized, ref["PRED_PENALIZED"].values)):
        assert np.abs(got - want).max() <= 5e-3
        order = np.argsort(-want, kind="stable")
        apart = np.abs(np.diff(want[order])) > 1e-2
        assert (np.diff(got[order])[apart] < 0).all()
    outdoor = cols["CATEGORY"] == "Outdoor"
    assert (penalized[outdoor] < preds[outdoor]).all()
    np.testing.assert_allclose(penalized[~outdoor], preds[~outdoor], rtol=0, atol=1e-6)
