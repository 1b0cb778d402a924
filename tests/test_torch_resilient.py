"""The port's resilient training (recman_tpu_torch/training/resilient.py,
a byte copy of the reference's, driven by ``Trainer.fit(resilience=)``
and ``Trainer.fit_stream(resilience=)``) on the CPU: every non-sharded
test of ``tests/test_resilient.py``, on a small xDeepFM (the port has no
FM) over the reference's 16-row synthetic dataframe, with DNN dropout
live so the restored generator matters.

A resumed run is held bit-equal (``torch.equal``) to the uninterrupted
one in params, optimizer state, step and generator. A resilient ``fit``
is held to JAX's on the same initial params within
``test_fit_matches_jax_trainer``'s bounds (1e-4 relative mean loss, 1e-4
absolute predictions): the reference's per-epoch seed gives both the same
batches.
"""

import os
import signal

import numpy as np
import pytest
import torch

import recman_tpu
import recman_tpu_torch
from recman_tpu.models import XDeepFM as JaxXDeepFM
from recman_tpu.training import LogLoss as JaxLogLoss
from recman_tpu.training import Resilience as JaxResilience
from recman_tpu.training import Trainer as JaxTrainer
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.training import (
    LogLoss,
    Preempted,
    Resilience,
    Trainer,
    TrainingDiverged,
)
from tests.test_torch_ckpt import _assert_states_equal
from tests.test_torch_xdeepfm import _schema
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

HP = {"learning_rate": 0.05, "optimizer": "adam", "embedding_size": 4,
      "cin_cross_layer_units": (4, 4), "cin_dropout": (1, 1, 1), "deep_hidden_units": (8, 8),
      "deep_dropout": (0.5, 0.5, 0.5)}


@pytest.fixture
def features(synthetic_df):
    return _schema(recman_tpu_torch, synthetic_df)


def make_trainer(feats, epoch=3, batch_size=4, seed=2019, hp=None, **kw):
    hpx = dict(HP, **(hp or {}))
    return Trainer(XDeepFM(feats, hpx), hpx, metrics=(LogLoss(),), epoch=epoch,
                   batch_size=batch_size, random_seed=seed, device="cpu", **kw)


class PreemptAtStep(Resilience):
    """Raises a real preemption signal just before global step ``at_step``
    completes (the handler ``fit`` installed catches it)."""

    def __init__(self, *args, at_step, **kwargs):
        super().__init__(*args, **kwargs)
        self.at_step = at_step

    def step_boundary(self, trainer, step, epoch, extra=None):
        if step == self.at_step:
            signal.raise_signal(self.preempt_signals[0])
        super().step_boundary(trainer, step, epoch, extra)


def _y(df):
    return df["LABEL"].values


class TestResilience:
    def test_periodic_save_retention_and_latest(self, tmp_path, synthetic_df, features):
        res = Resilience(tmp_path / "ckpts", every_steps=2, keep=2, preempt_signals=())
        t = make_trainer(features, epoch=2)
        t.fit(synthetic_df, _y(synthetic_df), resilience=res)
        dirs = sorted(d for d in os.listdir(tmp_path / "ckpts") if d.startswith("step_"))
        assert len(dirs) == 2, dirs  # retention pruned older saves
        path, meta = res.latest()
        # 16 rows / batch 4 -> 5 steps an epoch, 2 epochs = 10 steps
        assert meta["step"] == 10 and meta["epoch"] == 2
        assert os.path.basename(path) == dirs[-1]

    @pytest.mark.parametrize("steps_per_dispatch", [1, 3])
    def test_preempt_then_resume_matches_uninterrupted(self, tmp_path, synthetic_df,
                                                       features, steps_per_dispatch):
        """Preempted by SIGUSR1 mid-epoch 2 (global step 7 of 15; with groups
        of 3 steps and the tail one by one, at step 8, the end of epoch 2's
        group), resumed by a fresh Trainer."""
        df, y = synthetic_df, _y(synthetic_df)
        at = 7 if steps_per_dispatch == 1 else 8
        ref = make_trainer(features, steps_per_dispatch=steps_per_dispatch)
        ref.fit(df, y, resilience=Resilience(tmp_path / "ref", every_epochs=10**6,
                                             preempt_signals=()))
        before = signal.getsignal(signal.SIGUSR1)
        res = PreemptAtStep(tmp_path / "ck", at_step=at, every_steps=None, every_epochs=1,
                            preempt_signals=(signal.SIGUSR1,))
        t1 = make_trainer(features, steps_per_dispatch=steps_per_dispatch)
        with pytest.raises(Preempted):
            t1.fit(df, y, resilience=res)
        assert res.latest()[1]["step"] == at
        assert signal.getsignal(signal.SIGUSR1) is before  # uninstalled in a finally
        t2 = make_trainer(features, seed=2019, steps_per_dispatch=steps_per_dispatch)
        t2.fit(df, y, resilience=Resilience(tmp_path / "ck", preempt_signals=()))
        _assert_states_equal(ref.state, t2.state)
        assert t2.state.step == 15

    def test_completed_run_resume_is_noop(self, tmp_path, synthetic_df, features):
        df, y = synthetic_df, _y(synthetic_df)
        t = make_trainer(features, epoch=2)
        t.fit(df, y, resilience=Resilience(tmp_path / "done", preempt_signals=()))
        t2 = make_trainer(features, epoch=2)
        t2.fit(df, y, resilience=Resilience(tmp_path / "done", preempt_signals=()))
        assert t2.state.step == t.state.step == 10  # restored, no extra epochs
        _assert_states_equal(t.state, t2.state)

    def test_divergence_rolls_back_to_last_good(self, tmp_path, synthetic_df, features):
        res = Resilience(tmp_path / "div", preempt_signals=())
        t = make_trainer(features, epoch=1)
        t.fit(synthetic_df, _y(synthetic_df), resilience=res)  # epoch-1 ckpt
        good = {k: v.clone() for k, v in t.state.params.items()}
        t.state = t.state._replace(params={k: v * 100.0 for k, v in t.state.params.items()})
        with pytest.raises(TrainingDiverged):
            res.epoch_boundary(t, step=10, epoch=2, mean_loss=float("nan"))
        for name, want in good.items():
            assert torch.equal(t.state.params[name], want), name

    def test_signal_capture_and_handler_restore(self, tmp_path):
        res = Resilience(tmp_path / "sig", preempt_signals=(signal.SIGUSR1,))
        before = signal.getsignal(signal.SIGUSR1)
        res.install()
        try:
            os.kill(os.getpid(), signal.SIGUSR1)
            assert res.preempted
        finally:
            res.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is before

    def test_nonfinite_without_checkpoint_still_raises(self, tmp_path, features):
        res = Resilience(tmp_path / "empty", preempt_signals=())
        t = make_trainer(features, epoch=1)
        with pytest.raises(TrainingDiverged, match="no checkpoint"):
            res.epoch_boundary(t, step=1, epoch=1, mean_loss=float("inf"))

    def test_resilient_fit_matches_jax(self, tmp_path, synthetic_df):
        """Two epochs on the reference's resilient seeds, every keep 1, at the
        Trainer tests' rate 1e-3 (at 1e-2 Adam's ±lr moves of near-zero
        gradients pass the bounds within 10 steps of batch 4)."""
        df, y = synthetic_df, _y(synthetic_df)
        hp = dict(HP, deep_dropout=(1.0, 1.0, 1.0), learning_rate=0.001)
        jt = JaxTrainer(JaxXDeepFM(_schema(recman_tpu, df), hp), hp, metrics=(JaxLogLoss(),),
                        epoch=2, batch_size=4, random_seed=2019)
        params = {k: np.asarray(v) for k, v in jt.state.params.items()}
        jt.fit(df, y, resilience=JaxResilience(tmp_path / "jax", every_epochs=10**6,
                                               preempt_signals=()))
        tt = make_trainer(_schema(recman_tpu_torch, df), epoch=2, hp=hp)
        p = params_from_jax(params, device="cpu")
        tt.state = tt.state._replace(params=p, opt_state=tt.optimizer.init(p))
        tt.fit(df, y, resilience=Resilience(tmp_path / "port", every_epochs=10**6,
                                            preempt_signals=()))
        assert tt.state.step == int(jt.state.step) == 10
        assert abs(tt.last_mean_loss - jt.last_mean_loss) <= 1e-4 * abs(jt.last_mean_loss)
        np.testing.assert_allclose(tt.predict(df), jt.predict(df), rtol=0, atol=1e-4)


class TestStreamResilience:
    """Resumable fit_stream: checkpoints carry the stream position and a
    resumed run is bit-exact against the uninterrupted one."""

    def _chunks(self, df, features, n_chunks=3):
        data = features.transform(df, y=df["LABEL"].values)
        per = len(data["y"]) // n_chunks

        def factory():
            for c in range(n_chunks):
                yield {k: v[c * per:(c + 1) * per] for k, v in data.items()}

        return factory

    def test_stream_preempt_resume_bit_exact(self, tmp_path, synthetic_df, features):
        chunks = self._chunks(synthetic_df, features)
        ref = make_trainer(features, epoch=2, batch_size=2)
        ref.fit_stream(chunks, epochs=2, resilience=Resilience(
            tmp_path / "ref", every_epochs=10**6, preempt_signals=()))
        # preempted in epoch 1 inside chunk 1 (5 rows a chunk, batch 2 ->
        # 3 steps a chunk; step 5 = chunk 1, batch 2)
        res = PreemptAtStep(tmp_path / "ck", at_step=5, every_steps=None, every_epochs=1,
                            preempt_signals=(signal.SIGUSR1,))
        t1 = make_trainer(features, epoch=2, batch_size=2)
        with pytest.raises(Preempted):
            t1.fit_stream(chunks, epochs=2, resilience=res)
        _, meta = res.latest()
        assert meta["step"] == 5 and meta["stream"] == {"epoch": 1, "chunk": 1, "batch": 2}
        t2 = make_trainer(features, epoch=2, batch_size=2)
        t2.fit_stream(chunks, epochs=2, resilience=Resilience(tmp_path / "ck",
                                                              preempt_signals=()))
        _assert_states_equal(ref.state, t2.state)
        assert t2.state.step == 18

    def test_stream_completed_resume_is_noop(self, tmp_path, synthetic_df, features):
        chunks = self._chunks(synthetic_df, features)
        t = make_trainer(features, epoch=1, batch_size=2)
        t.fit_stream(chunks, epochs=1, resilience=Resilience(tmp_path / "done",
                                                             preempt_signals=()))
        t2 = make_trainer(features, epoch=1, batch_size=2)
        t2.fit_stream(chunks, epochs=1, resilience=Resilience(tmp_path / "done",
                                                              preempt_signals=()))
        assert t2.state.step == t.state.step == 9

    def test_plain_iterator_with_resilience_rejected(self, tmp_path, synthetic_df,
                                                     features):
        chunks = self._chunks(synthetic_df, features)
        t = make_trainer(features, epoch=1, batch_size=2)
        with pytest.raises(AssertionError, match="callable"):
            t.fit_stream(list(chunks()), epochs=1,
                         resilience=Resilience(tmp_path / "x", preempt_signals=()))
