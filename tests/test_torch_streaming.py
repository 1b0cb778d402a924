"""The port's streaming input pipeline on the CPU: the chunk iterators
(``data/streaming.py``) and the native Criteo parser
(``data/native_loader.py``, byte copies of the reference's, building the
repository's ``native/criteo_parser.cpp``), ``Trainer.fit_stream``,
``predict_stream``, ``evaluate_stream`` and the Criteo example's native
path. The ported cases of ``tests/test_streaming.py`` and
``tests/test_native_loader.py`` run on a small xDeepFM (the port has no
DeepFM).

- A chunked fit replays the resident fit's batches: bit-equal
  (``torch.equal``; the reference holds its own to 1e-6).
- ``fit_stream`` against JAX's ``fit_stream`` on the same chunks and the
  same initial params, every keep 1, on the kernels' route (as the
  large-batch Trainer test): predictions within 1e-4 absolute and the
  logloss within 1e-4 relative (``test_fit_matches_jax_trainer``'s
  bounds).
- The native parse equals the pandas loader (dense columns to 1e-6
  relative, the rest exact, as the reference's test) and the JAX
  package's native parse (exact: the same library).
"""

import logging

import numpy as np
import pytest
import torch

from recman_tpu.data import create_criteo_features as jax_criteo_features
from recman_tpu.data import iter_array_chunks as jax_iter_array_chunks
from recman_tpu.data import load_criteo_tsv_native as jax_native
from recman_tpu.models import XDeepFM as JaxXDeepFM
from recman_tpu.ops import cin_interact as jax_cin_interact
from recman_tpu.ops import embedding as jax_emb
from recman_tpu.training import LogLoss as JaxLogLoss
from recman_tpu.training import Trainer as JaxTrainer
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.data import (
    CAT_NAMES,
    INT_NAMES,
    calibrated_criteo_arrays,
    create_criteo_features,
    iter_array_chunks,
    iter_criteo_chunks,
    load_criteo_tsv,
    load_criteo_tsv_native,
    synthetic_criteo_arrays,
)
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.ops import embedding as torch_emb
from recman_tpu_torch.training import LogLoss, RocAucScore, Trainer, batch_indices
from tests.test_native_loader import _make_tsv
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

HP = {"embedding_size": 4, "cin_cross_layer_units": (8,), "cin_dropout": (1, 1),
      "deep_hidden_units": (8,), "deep_dropout": (1.0, 1.0), "learning_rate": 0.01}


def _setup(n=256, buckets=512):
    return create_criteo_features(num_buckets=buckets), \
        synthetic_criteo_arrays(n, num_buckets=buckets, seed=11)


def _trainer(fs, batch_size=64, **kw):
    return Trainer(XDeepFM(fs, HP), HP, metrics=(LogLoss(),), batch_size=batch_size,
                   random_seed=5, device="cpu", **kw)


class TestIterArrayChunks:
    def test_partitions_rows(self):
        _, data = _setup(n=100)
        chunks = list(iter_array_chunks(data, 32))
        assert [len(c["y"]) for c in chunks] == [32, 32, 32, 4]
        np.testing.assert_array_equal(np.concatenate([c["C1"] for c in chunks]), data["C1"])

    def test_shuffle_covers_all_rows(self):
        _, data = _setup(n=100)
        got = np.concatenate([c["y"] for c in iter_array_chunks(data, 32, shuffle_seed=3)])
        np.testing.assert_array_equal(np.sort(got), np.sort(data["y"]))
        assert not np.array_equal(got, data["y"])


class TestFitStream:
    def _train_manual(self, fs, data, chunk_rows, batch_size=64):
        """The resident fit_on_batch over exactly the batches
        fit_stream(shuffle_in_chunk=False) derives from the chunks."""
        t = _trainer(fs, batch_size)
        n = len(data["y"])
        dev, layout = t._to_device(data, data["y"])
        for s in range(0, n, chunk_rows):
            for row in batch_indices(min(chunk_rows, n - s), batch_size):
                t.fit_on_batch(dev, np.where(row >= 0, row + s, -1).astype(np.int32), layout)
        return t

    @pytest.mark.parametrize("chunk_rows", [256, 96])
    def test_matches_resident_batches(self, chunk_rows):
        fs, data = _setup(n=256)
        ref = self._train_manual(fs, data, chunk_rows)
        got = _trainer(fs)
        got.fit_stream(iter_array_chunks(data, chunk_rows), epochs=1, shuffle_in_chunk=False)
        assert got.state.step == ref.state.step
        for name, want in ref.state.params.items():
            assert torch.equal(got.state.params[name], want), name

    def test_multi_epoch_needs_callable(self):
        fs, data = _setup(n=128)
        with pytest.raises(AssertionError, match="callable"):
            _trainer(fs).fit_stream(iter_array_chunks(data, 64), epochs=2)

    def test_multi_epoch_callable_learns(self):
        fs, data = _setup(n=512)
        t = _trainer(fs)
        before = t.evaluate(data, data["y"])[0]
        t.fit_stream(lambda: iter_array_chunks(data, 128, shuffle_seed=9), epochs=2)
        assert t.state.step == 2 * 4 * 3 and t.evaluate(data, data["y"])[0] < before

    def test_matches_jax_fit_stream(self):
        """Two epochs over chunks of 96 rows, shuffled in each chunk (the
        reference's seed random_seed + 7919 * epoch + chunk), on the
        kernels' route, where both sides round alike (the port's K3 and CIN
        twins, JAX's Pallas kernels interpreted): on the default routes
        Adam's ±lr moves of near-zero gradients that round apart pass the
        bounds in the resident fit as well."""
        buckets, hp = 64, dict(HP, learning_rate=0.001)
        data = synthetic_criteo_arrays(256, num_buckets=buckets, seed=11)
        x = {k: v for k, v in data.items() if k != "y"}
        jt = JaxTrainer(JaxXDeepFM(jax_criteo_features(num_buckets=buckets), hp), hp,
                        metrics=(JaxLogLoss(),), batch_size=64, random_seed=5)
        params = {k: np.asarray(v) for k, v in jt.state.params.items()}
        with jax_emb.fused_grad(True), jax_cin_interact.pallas_cin(True), \
                jax_emb.grad_kernel("segmat"):
            jt.fit_stream(lambda: jax_iter_array_chunks(data, 96), epochs=2)
        tt = Trainer(XDeepFM(create_criteo_features(num_buckets=buckets), hp), hp,
                     metrics=(LogLoss(),), batch_size=64, random_seed=5, device="cpu")
        p = params_from_jax(params, device="cpu")
        tt.state = tt.state._replace(params=p, opt_state=tt.optimizer.init(p))
        with torch_emb.fused_grad(True), torch_emb.grad_kernel("segmat"):
            tt.fit_stream(lambda: iter_array_chunks(data, 96), epochs=2)
        assert tt.state.step == int(jt.state.step) == 2 * (2 + 2 + 2)
        np.testing.assert_allclose(tt.predict(x), jt.predict(x), rtol=0, atol=1e-4)
        (jl,), (tl,) = jt.evaluate(x, data["y"]), tt.evaluate(x, data["y"])
        assert abs(tl - jl) <= 1e-4 * abs(jl)


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    return _make_tsv(str(tmp_path_factory.mktemp("criteo") / "day.tsv"), n_rows=157)


class TestCriteoChunkStream:
    def test_native_parse_matches_pandas_and_the_reference(self, tsv):
        got = load_criteo_tsv_native(tsv, num_buckets=1000)
        raw = load_criteo_tsv(tsv)
        want = create_criteo_features(num_buckets=1000).transform(raw, y=raw["y"])
        np.testing.assert_array_equal(got["y"], want["y"])
        for name in INT_NAMES:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6, err_msg=name)
        for name in CAT_NAMES:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        ref = jax_native(tsv, num_buckets=1000)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    def test_range_reads_equal_full_parse(self, tsv):
        full = load_criteo_tsv_native(tsv, num_buckets=1000)
        chunks = list(iter_criteo_chunks(tsv, 1000, chunk_rows=50))
        assert [len(c["y"]) for c in chunks] == [50, 50, 50, 7]
        for key in full:
            np.testing.assert_array_equal(np.concatenate([c[key] for c in chunks]), full[key],
                                          err_msg=key)

    def test_max_rows(self, tmp_path):
        path = _make_tsv(str(tmp_path / "day2.tsv"), n_rows=80, seed=1)
        chunks = list(iter_criteo_chunks(path, 1000, chunk_rows=32, max_rows=70))
        assert sum(len(c["y"]) for c in chunks) == 70

    def test_criteo_example_reads_the_tsv_natively(self, tsv, monkeypatch, caplog):
        """The native path, the pandas path, and the pandas path again when
        the parser does not build (with a warning): the same encoded rows,
        so the same trained model."""
        from recman_tpu_torch.data.native_loader import NativeBuildError
        from recman_tpu_torch.examples import criteo_xdeepfm

        kw = dict(tsv=tsv, rows=150, num_buckets=1000, batch_size=64, embedding_size=8,
                  device="cpu")

        def main(**extra):  # fit reshuffles from numpy's global generator
            np.random.seed(0)
            return criteo_xdeepfm.main(**kw, **extra)

        native, res_n = main()
        pandas, res_p = main(native=False)

        def no_build(*a, **k):
            raise NativeBuildError("no g++")

        monkeypatch.setattr(criteo_xdeepfm, "load_criteo_tsv_native", no_build)
        with caplog.at_level(logging.WARNING):
            fallback, res_f = main()
        assert "native parser unavailable" in caplog.text
        assert native.state.step == 135 // 64 + 1
        assert res_n == res_p == res_f and np.isfinite(res_n[0])
        for t in (pandas, fallback):
            for k, v in native.state.params.items():
                assert torch.equal(t.state.params[k], v), k


class TestPredictStream:
    @pytest.fixture(scope="class")
    def trained(self):
        fs = create_criteo_features(num_buckets=64)
        arrs = calibrated_criteo_arrays(1024, num_buckets=64, seed=1)
        hp = {"embedding_size": 4, "cin_cross_layer_units": (8,), "cin_dropout": (1, 1),
              "deep_hidden_units": (16,), "deep_dropout": (1.0, 1.0)}
        tr = Trainer(XDeepFM(fs, hp), {"learning_rate": 1e-3}, batch_size=128,
                     metrics=(LogLoss(), RocAucScore()), epoch=1, device="cpu")
        tr.fit(arrs, arrs["y"], random_seed_for_mini_batch=False)
        return tr, arrs

    def test_predict_stream_matches_resident_predict(self, trained):
        tr, arrs = trained
        resident = tr.predict({k: v for k, v in arrs.items() if k != "y"})
        np.testing.assert_array_equal(tr.predict_stream(iter_array_chunks(arrs, 300)), resident)
        assert tr.predict_stream([]).shape == (0,)

    def test_evaluate_stream_matches_resident(self, trained):
        tr, arrs = trained
        resident = tr.evaluate({k: v for k, v in arrs.items() if k != "y"}, arrs["y"])
        assert tr.evaluate_stream(lambda: iter_array_chunks(arrs, 300)) == resident
