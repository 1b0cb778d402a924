"""The port's serving artifacts (``recman_tpu_torch.serving``:
``Predictor.export`` and ``ExportedPredictor``) against the JAX package on
the CPU, case by case as ``tests/test_serving_export.py``: the port's
artifact serves JAX's ``Predictor.predict`` for the same params (carried
over by ``convert.params_from_jax``), and its int8 artifacts JAX's.

Tolerance for predictions: ``PRED_TOL`` 1e-5, as the live predictor's
(tests/test_torch_xdeepfm.py): the same roundings, f32 sums in another
order. The load-time int8 artifact is held within 5e-3 and the runtime
one within 1e-2 of f32 (the reference's quantization bounds), and the two
int8 forms within 1e-6 of each other: the same dequantized values,
multiplied before or after the gather.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import recman_tpu
import recman_tpu_torch
from recman_tpu.examples.din_synthetic import make_data as jax_din_data
from recman_tpu.examples.xdeepfm_synthetic import COLUMNS, ROWS
from recman_tpu.models import DIN as JaxDIN
from recman_tpu.models import XDeepFM as JaxXDeepFM
from recman_tpu.ops.embedding import quantize_table_int8 as jax_quantize
from recman_tpu.serving import ExportedPredictor as JaxExportedPredictor
from recman_tpu.serving import Predictor as JaxPredictor
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.examples.din_synthetic import make_data
from recman_tpu_torch.models import DIN, XDeepFM
from recman_tpu_torch.ops import QuantTable, fused_grad, pallas_cin
from recman_tpu_torch.serving import (
    EXPORT_BLOB,
    EXPORT_META,
    EXPORT_PARAMS,
    EXPORT_SCHEMA,
    EXPORT_SCHEMA_JSON,
    Q8,
    Q8_SCALE,
    ExportedPredictor,
    Predictor,
    op_nodes,
)
from recman_tpu_torch.training import Trainer
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
PRED_TOL = 1e-5
HP = {"embedding_size": 4}


def _schema(pkg, df):
    """The reference test's synthetic schema, in one package's classes."""
    fs = pkg.FeatureSet()
    for name in ("USER_ID", "CLASS_ID", "CATEGORY"):
        fs[name] = pkg.SparseFeat(name, feat_size=len(np.unique(df[name].values)))
    fs["HISTORICAL_CATEGORIES"] = pkg.MultiValCsvFeat(
        "HISTORICAL_CATEGORIES", tags=("a", "b", "c", "d"))
    fs.initialize(df)
    return fs


@pytest.fixture(scope="module")
def xdeepfm():
    """(JAX model, JAX params, the port's Predictor on the CPU, the rows);
    the JAX params drawn from PRNGKey(3) as in the reference test."""
    df = pd.DataFrame(ROWS, columns=COLUMNS)
    jm = JaxXDeepFM(_schema(recman_tpu, df), HP)
    jparams = jm.init_params(jax.random.PRNGKey(3))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tm = XDeepFM(_schema(recman_tpu_torch, df), HP)
    pred = Predictor(tm, params_from_jax(np_params, device="cpu"), batch_size=8, device="cpu")
    return jm, jparams, pred, df


@pytest.fixture(scope="module")
def jax_preds(xdeepfm):
    jm, jparams, _, df = xdeepfm
    return JaxPredictor(jm, jparams, batch_size=8).predict(df)


def _export(pred, path, df, **kw):
    return ExportedPredictor.load(pred.export(str(path), df, **kw), device="cpu")


class TestExportRoundtrip:
    def test_artifact_files_and_parity(self, tmp_path, xdeepfm, jax_preds):
        _, _, pred, df = xdeepfm
        d = pred.export(str(tmp_path), df)
        for name in (EXPORT_BLOB, EXPORT_META, EXPORT_PARAMS, EXPORT_SCHEMA_JSON):
            assert (tmp_path / name).exists(), name
        # built-in feature types serialize as pure-data JSON; no pickle
        assert not (tmp_path / EXPORT_SCHEMA).exists()
        served = ExportedPredictor.load(d, device="cpu")
        assert served.meta["platforms"] == ["cpu"] and served.meta["quant_mode"] == "none"
        got = served.predict(df)
        assert got.shape == jax_preds.shape == (len(df),)
        np.testing.assert_allclose(got, jax_preds, rtol=0, atol=PRED_TOL)
        np.testing.assert_allclose(got, pred.predict(df), rtol=0, atol=1e-6)
        assert served.predict(df.iloc[:0]).shape == (0,)

    @pytest.mark.parametrize("platforms", [("cpu",), ("cpu", "cuda")])
    def test_export_listing_the_cpu_traces_the_plain_path(self, tmp_path, xdeepfm, jax_preds,
                                                          platforms):
        """An export that must serve on the CPU traces the CPU's program on
        the plain path even where the exporting host would take the
        kernels: the switches are forced on and that program holds no op
        of the port's kernels. An artifact that also lists the card holds
        a second program for it, with K4 as its op node, so the card never
        serves the plain path."""
        _, _, pred, df = xdeepfm
        with fused_grad(True), pallas_cin(True):
            d = pred.export(str(tmp_path), df, platforms=platforms)
        assert op_nodes(d, "cpu") == set()
        if "cuda" in platforms:
            assert op_nodes(d, "cuda") == {"recman_tpu_torch.cin_interact_fwd.default"}
            assert (tmp_path / EXPORT_BLOB).exists() and (tmp_path / "serving_fn_cuda.pt2").exists()
        got = ExportedPredictor.load(d, device="cpu").predict(df)
        np.testing.assert_allclose(got, jax_preds, rtol=0, atol=PRED_TOL)

    @pytest.mark.parametrize("batch, op", [(8, "cin_interact_fwd"), (32, "cin_chain_fwd")])
    def test_cuda_export_keeps_the_kernel_ops(self, tmp_path, xdeepfm, jax_preds, batch, op):
        """An export for the card alone keeps K4 (per-layer CIN) or K1 (the
        chain, at B*D 128) as one node of the registered op; on the CPU the
        op runs its plain version, and the program serves JAX's
        predictions. The artifact does not load for the CPU."""
        _, _, pred, df = xdeepfm
        d = pred.export(str(tmp_path), df, batch_size=batch, platforms=("cuda",))
        assert op_nodes(d) == {f"recman_tpu_torch.{op}.default"}
        with pytest.raises(ValueError, match="serves on"):
            ExportedPredictor.load(d, device="cpu")
        program = torch.export.load(os.path.join(d, EXPORT_BLOB)).module()
        rows = np.minimum(np.arange(batch), len(df) - 1)
        enc = pred.model.feat_dict.transform(df)
        batch_in = {k: torch.as_tensor(enc[k][rows]) for k in sorted(enc) if k != "y"}
        got = program(dict(pred.params), batch_in).numpy()
        m = min(batch, len(df))
        np.testing.assert_allclose(got[:m], jax_preds[:m], rtol=0, atol=PRED_TOL)

    def test_padding_path(self, tmp_path, xdeepfm, jax_preds):
        """16 rows through a batch-5 artifact: 4 calls, the last edge-padded."""
        _, _, pred, df = xdeepfm
        served = _export(pred, tmp_path, df, batch_size=5)
        np.testing.assert_allclose(served.predict(df), jax_preds, rtol=0, atol=PRED_TOL)

    def test_encoded_dict_input(self, tmp_path, xdeepfm, jax_preds):
        _, _, pred, df = xdeepfm
        served = _export(pred, tmp_path, df)
        data = served.feat_dict.transform(df)
        np.testing.assert_allclose(served.predict(data), jax_preds, rtol=0, atol=PRED_TOL)

    def test_override_baked_in(self, tmp_path, xdeepfm):
        """Overrides active at export time are constants of the program."""
        jm, jparams, pred, df = xdeepfm
        base = pred.export(str(tmp_path / "base"), df)
        feats = (pred.model.feat_dict["CATEGORY"], jm.feat_dict["CATEGORY"])
        try:
            for f in feats:
                f.set_weights({"Outdoor": -5})
            overridden = pred.export(str(tmp_path / "ovr"), df)
            want = JaxPredictor(jm, jparams, batch_size=8).predict(df, apply_overrides=True)
        finally:
            for f in feats:
                f.set_weights({})
        got_base = ExportedPredictor.load(base, device="cpu").predict(df)
        got_ovr = ExportedPredictor.load(overridden, device="cpu").predict(df)
        np.testing.assert_allclose(got_ovr, want, rtol=0, atol=PRED_TOL)
        outdoor = np.asarray(df["CATEGORY"] == "Outdoor")
        assert (np.abs(got_ovr - got_base)[outdoor] > 1e-4).all()
        np.testing.assert_allclose(got_base[~outdoor], got_ovr[~outdoor], rtol=0, atol=1e-6)

    def test_load_imports_no_model_code(self, tmp_path, xdeepfm):
        """A fresh process loads and serves the artifact with the port's
        ops and features alone: no ``recman_tpu_torch.models`` module is
        imported."""
        _, _, pred, df = xdeepfm
        d = pred.export(str(tmp_path / "art"), df)
        enc = pred.model.feat_dict.transform(df)
        np.savez(tmp_path / "batch.npz", **enc)
        np.save(tmp_path / "want.npy", pred.predict(df))
        code = (
            "import sys, numpy as np\n"
            "from recman_tpu_torch.serving import ExportedPredictor\n"
            f"s = ExportedPredictor.load({d!r}, device='cpu')\n"
            f"z = dict(np.load({str(tmp_path / 'batch.npz')!r}))\n"
            f"assert np.abs(s.predict(z) - np.load({str(tmp_path / 'want.npy')!r})).max() <= 1e-6\n"
            "bad = [m for m in sys.modules if m.startswith(('recman_tpu_torch.models', 'jax'))]\n"
            "assert not bad, bad\n"
        )
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]

    def test_quantized_embeddings_artifact(self, tmp_path, xdeepfm):
        """int8 per-row storage: the npz's ``::q8``/``::q8scale`` bytes are
        the reference's ``quantize_table_int8``'s, the predictions within
        quantization error of f32 and truly quantized."""
        _, jparams, pred, df = xdeepfm
        s32 = _export(pred, tmp_path / "f32", df)
        sq = _export(pred, tmp_path / "q8", df, quantize_embeddings=True)
        assert sq.meta["quantized"] and sq.meta["quant_mode"] == "load"
        with np.load(str(tmp_path / "q8" / EXPORT_PARAMS)) as z:
            for name in sq.meta["quantized"]:
                q, scale = jax_quantize(np.asarray(jparams[name]))
                assert z[f"{name}::q8"].dtype == np.int8
                assert z[f"{name}::q8"].tobytes() == q.tobytes()
                assert z[f"{name}::q8scale"].tobytes() == scale.tobytes()
        want, got = s32.predict(df), sq.predict(df)
        np.testing.assert_allclose(got, want, atol=5e-3)
        assert not np.allclose(got, want, atol=1e-8)

    def test_runtime_quantized_lookup(self, tmp_path, xdeepfm):
        """"runtime": the tables stay int8 in memory (the program makes each
        a ``QuantTable`` and gathers, then dequantizes); the predictions are
        JAX's runtime artifact's, and the load-time artifact's to 1e-6."""
        jm, jparams, pred, df = xdeepfm
        s32 = _export(pred, tmp_path / "f32", df)
        sr = _export(pred, tmp_path / "rq8", df, quantize_embeddings="runtime")
        assert sr.meta["quant_mode"] == "runtime" and sr.meta["quantized"]
        names = sr.meta["quantized"]
        assert sorted(k for k in sr.params if k.endswith(Q8)) == sorted(n + Q8 for n in names)
        assert all(sr.params[n + Q8].dtype == torch.int8 for n in names)
        assert not any(n in sr.params for n in names)
        f32_bytes = sum(s32.params[k].numel() * 4 for k in names)
        q_bytes = sum(sr.params[n + Q8].numel() + 4 * sr.params[n + Q8_SCALE].numel()
                      for n in names)
        assert q_bytes < f32_bytes / 1.8  # 4k/(k+4): 2 at k 4, 3.2 at k 16

        got = sr.predict(df)
        np.testing.assert_allclose(got, s32.predict(df), atol=1e-2)
        assert not np.allclose(got, s32.predict(df), atol=1e-8)
        sq = _export(pred, tmp_path / "q8", df, quantize_embeddings=True)
        np.testing.assert_allclose(got, sq.predict(df), rtol=0, atol=1e-6)
        jd = JaxPredictor(jm, jparams, batch_size=8).export(
            str(tmp_path / "jax_rq8"), df, quantize_embeddings="runtime")
        want = JaxExportedPredictor.load(jd).predict(df)
        np.testing.assert_allclose(got, want, rtol=0, atol=PRED_TOL)

    def test_quant_table_has_no_gradient_path(self):
        from recman_tpu_torch.ops import embedding_lookup

        scale = torch.ones(3, requires_grad=True)
        table = QuantTable(torch.ones((3, 2), dtype=torch.int8), scale)
        with pytest.raises(RuntimeError, match="lookup-only"):
            embedding_lookup(table, torch.tensor([0, 2]))


def _din_pair(n, seed):
    """DIN on the reference's din_synthetic rows, one schema per package."""
    rows = make_data(n=n, n_items=10, max_hist=4)
    df = jax_din_data(n=n, n_items=10, max_hist=4)
    models = []
    for pkg, cls, data in ((recman_tpu, JaxDIN, df), (recman_tpu_torch, DIN, rows)):
        fs = pkg.FeatureSet()
        item = pkg.SparseFeat("item_id", feat_size=len(np.unique(data["item_id"])))
        fs["item_id"] = item
        fs["hist_items"] = pkg.SequenceFeat("hist_items", id_feat=item, max_len=4)
        fs.initialize(data)
        models.append(cls(fs))
    jparams = models[0].init_params(jax.random.PRNGKey(seed))
    return models[0], jparams, models[1], rows, df


class TestExportSequenceModels:
    def test_din_export_roundtrip(self, tmp_path):
        """(B, L) history arrays trace and pad; Dice serves from its frozen
        moments; the artifact serves JAX's predictions."""
        jm, jparams, tm, rows, df = _din_pair(64, 7)
        params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
        pred = Predictor(tm, params, batch_size=16, device="cpu")
        enc = tm.feat_dict.transform(rows)
        served = _export(pred, tmp_path, enc, batch_size=10)  # the padding path too
        want = JaxPredictor(jm, jparams, batch_size=16).predict(df)
        np.testing.assert_allclose(served.predict(enc), want, rtol=0, atol=PRED_TOL)
        np.testing.assert_allclose(served.predict(enc), pred.predict(enc), rtol=0, atol=1e-6)

    def test_din_dice_predictions_batch_invariant(self, tmp_path):
        """A trained and calibrated DIN scores each row the same whatever
        rows come with it, live and through the artifact."""
        _, _, model, rows, _ = _din_pair(128, 7)
        enc = model.feat_dict.transform(rows)
        trainer = Trainer(model, {"learning_rate": 0.02, "optimizer": "adam"}, epoch=1,
                          batch_size=32, random_seed=2019, device="cpu")
        trainer.fit(enc, rows["label"], random_seed_for_mini_batch=False)
        head = {k: v[:40] for k, v in enc.items()}
        tail = {k: v[40:] for k, v in enc.items()}
        full = trainer.predict(enc)
        np.testing.assert_allclose(
            full, np.concatenate([trainer.predict(head), trainer.predict(tail)]),
            rtol=1e-6, atol=1e-7)
        served = _export(Predictor(model, trainer.params, batch_size=16, device="cpu"),
                         tmp_path, enc, batch_size=16)
        np.testing.assert_allclose(
            served.predict(enc),
            np.concatenate([served.predict(head), served.predict(tail)]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(served.predict(enc), full, rtol=0, atol=1e-6)
        assert any("_dice_mean_" in k for k in trainer.params)
        moments = [v.numpy() for k, v in trainer.params.items() if "_dice_var_" in k]
        assert any(not np.allclose(v, 1.0) for v in moments), "moments never written"
