"""The port's Trainer and ML-100K pipeline (recman_tpu_torch) against the
JAX package on the CPU.

- The numpy loader gives every encoded array of the reference's pandas
  loader, equal.
- ``Trainer.fit`` for one epoch on a 1% ML-100K subsample (5 steps of 128),
  every keep 1, the same initial params (``convert.params_from_jax``) and
  ``random_seed_for_mini_batch=False`` on both sides, against JAX's
  ``Trainer.fit``: the epoch's mean loss within 1e-4 relative and the
  valid predictions within 1e-4 absolute. Two routes: each package's
  default CPU path, and the kernels' path (the port's K1/K2/K6 twins
  under ``fused_grad(True), grad_kernel("segmat")`` against the JAX
  Pallas kernels interpreted under the same contexts and
  ``pallas_cin(True)``). Measured: loss 7.5e-7 / 1.7e-8 relative,
  predictions 6.7e-5 / 1.2e-6 absolute. The bound is not tighter because
  Adam's first steps move each param by about ±lr whatever the size of
  its gradient, so a gradient near 0 whose last bits differ (CIN's bf16
  roundings, sums in another order) can move a param the other way; more
  steps compound it.
- The large-batch slice: ``Trainer.fit`` with ``large_batch_schedule``
  (warmup from 0, then cosine) and Adam on a small Criteo-shaped set
  against JAX's ``Trainer`` with the reference's schedule, the same
  bounds; both examples of the slice end to end at a few hundred rows.
"""

import sys

import numpy as np
import pandas as pd
import pytest
import torch

from recman_tpu.data import create_ml_features as jax_ml_features
from recman_tpu.data import get_ml_dataset as jax_ml_dataset
from recman_tpu.models import XDeepFM as JaxXDeepFM
from recman_tpu.ops import cin_interact as jax_cin_interact
from recman_tpu.ops import embedding as jax_emb
from recman_tpu.training import LogLoss as JaxLogLoss
from recman_tpu.training import Trainer as JaxTrainer
from recman_tpu.training.trainer import batch_indices as jax_batch_indices
from recman_tpu_torch import serving
from recman_tpu_torch.convert import params_from_jax
from recman_tpu_torch.data import concat_rows, create_ml_features, get_ml_dataset
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.ops import cin_chain, segment_matmul
from recman_tpu_torch.ops import embedding as torch_emb
from recman_tpu_torch.training import LogLoss, RocAucScore, Trainer, batch_indices
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

FRAC = 0.01
HPARAMS = {"deep_dropout": (1.0, 1.0, 1.0)}  # CIN's keeps default to 1
LOSS_REL, PRED_ABS = 1e-4, 1e-4


def _contexts(route, *ctx_fns):
    import contextlib

    stack = contextlib.ExitStack()
    if route == "kernels":
        for fn in ctx_fns:
            stack.enter_context(fn)
    return stack


@pytest.fixture(scope="module")
def ml():
    """Both loaders at FRAC, each encoded by its own package."""
    jtr, jva, _, jdom = jax_ml_dataset(frac=FRAC, random_seed=2019)
    jfs = jax_ml_features(pd.concat([jtr, jva]), jdom)
    ttr, tva, _, tdom = get_ml_dataset(frac=FRAC, random_seed=2019)
    tfs = create_ml_features(concat_rows(ttr, tva), tdom)
    return {
        "jax": (jfs, jfs.transform(jtr), jtr["label"].values, jfs.transform(jva)),
        "port": (tfs, tfs.transform(ttr), ttr["label"], tfs.transform(tva)),
        "y_valid": tva["label"],
    }


def test_numpy_loader_matches_the_pandas_loader():
    jax_sets = jax_ml_dataset(frac=0.5, random_seed=2019)
    port_sets = get_ml_dataset(frac=0.5, random_seed=2019)
    assert port_sets[3] == jax_sets[3]
    jfs = jax_ml_features(pd.concat(jax_sets[:2]), jax_sets[3])
    tfs = create_ml_features(concat_rows(*port_sets[:2]), port_sets[3])
    assert [(f.name, f.feat_size) for f in tfs.values()] == \
        [(f.name, f.feat_size) for f in jfs.values()]
    for jdf, tcols in zip(jax_sets[:3], port_sets[:3]):
        assert list(tcols) == list(jdf.columns)
        ref = jfs.transform(jdf, y=jdf["label"].values)
        got = tfs.transform(tcols, y=tcols["label"])
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
            np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(tcols["rating"], jdf["rating"].values)


def _jax_fit(ml, route):
    jfs, xtr, ytr, xva = ml["jax"]
    model = JaxXDeepFM(jfs, HPARAMS)
    trainer = JaxTrainer(model, HPARAMS, metrics=(JaxLogLoss(),), epoch=1, batch_size=128,
                         random_seed=2019)
    params = {k: np.asarray(v) for k, v in trainer.state.params.items()}
    with _contexts(route, jax_emb.fused_grad(True), jax_cin_interact.pallas_cin(True),
                   jax_emb.grad_kernel("segmat")):
        trainer.fit(xtr, ytr, random_seed_for_mini_batch=False)
        preds = trainer.predict(xva)
    return params, trainer.last_mean_loss, preds


def _port_fit(ml, params, route):
    tfs, xtr, ytr, xva = ml["port"]
    model = XDeepFM(tfs, HPARAMS)
    trainer = Trainer(model, HPARAMS, metrics=(LogLoss(),), epoch=1, batch_size=128,
                      random_seed=2019, device="cpu")
    p = params_from_jax(params, device="cpu")
    trainer.state = trainer.state._replace(params=p, opt_state=trainer.optimizer.init(p))
    with _contexts(route, torch_emb.fused_grad(True), torch_emb.grad_kernel("segmat")):
        trainer.fit(xtr, ytr, random_seed_for_mini_batch=False)
        preds = trainer.predict(xva)
    return trainer, preds


@pytest.mark.parametrize("route", ["default", "kernels"])
def test_fit_matches_jax_trainer(ml, route):
    params, jax_loss, jax_preds = _jax_fit(ml, route)
    launches = (cin_chain.LAUNCHES, cin_chain.BWD_LAUNCHES, segment_matmul.ROWS_LAUNCHES)
    trainer, preds = _port_fit(ml, params, route)
    assert launches == (cin_chain.LAUNCHES, cin_chain.BWD_LAUNCHES, segment_matmul.ROWS_LAUNCHES)
    assert trainer.state.step == len(ml["port"][2]) // 128 + 1
    assert abs(trainer.last_mean_loss - jax_loss) <= LOSS_REL * abs(jax_loss)
    assert preds.shape == jax_preds.shape == (len(ml["port"][3]["user_id"]),)
    assert np.abs(preds - jax_preds).max() <= PRED_ABS


def _small_trainer(ml, **kw):
    tfs = ml["port"][0]
    hp = dict(HPARAMS, **kw.pop("hp", {}))
    return Trainer(XDeepFM(tfs, hp), hp, metrics=(LogLoss(), RocAucScore()), epoch=1,
                   batch_size=128, device="cpu", **kw)


@pytest.mark.parametrize("grouping", [{"steps_per_dispatch": 2}, {"epoch_in_one_dispatch": True}])
def test_grouped_fit_branches_train_the_per_step_trajectory(ml, grouping):
    _, xtr, ytr, xva = ml["port"]
    a, b = _small_trainer(ml), _small_trainer(ml, **grouping)
    for t in (a, b):
        t.fit(xtr, ytr, random_seed_for_mini_batch=False)
    assert a.last_mean_loss == pytest.approx(b.last_mean_loss, rel=1e-6)
    np.testing.assert_allclose(a.predict(xva), b.predict(xva), rtol=0, atol=1e-6)


def test_fit_logs_evals_and_calls_back(ml, tmp_path, monkeypatch):
    from recman_tpu_torch.obs import BestModelFinder, TensorBoardLogger

    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the JSONL fallback
    _, xtr, ytr, xva = ml["port"]
    yva = ml["y_valid"]
    tb = TensorBoardLogger(sess_num=0, log_dir=str(tmp_path / "logs"), run_name="run")
    finder = BestModelFinder()
    trainer = _small_trainer(ml)
    trainer.fit(xtr, ytr, X_valid=xva, y_valid=yva, tb_logger=tb, epoch_callback=finder)
    tb.close()
    assert finder.best_model is trainer and len(finder.best_eval_results) == 2
    lines = (tmp_path / "logs" / "run" / "hp_0.metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 and '"VALID_roc_auc"' in lines[-1]
    res = trainer.evaluate(xva, yva)
    assert res == finder.best_eval_results[-1]


def test_eval_in_training_mode_keeps_dropout_live(ml):
    _, _, _, xva = ml["port"]
    trainer = _small_trainer(ml, hp={"deep_dropout": (0.5, 0.5, 0.5)})
    plain = trainer.predict(xva)
    live = trainer.predict(xva, training=True)
    assert np.isfinite(live).all() and not np.allclose(live, plain)
    np.testing.assert_array_equal(live, trainer.predict(xva, training=True))  # seeded 0
    step = trainer._eval_step(trainer.params, trainer._to_device(xva)[0],
                              torch.arange(8), None, False, trainer._to_device(xva)[1])
    np.testing.assert_allclose(step.numpy(), plain[:8], rtol=0, atol=1e-7)


def test_profiler_hooks_trace_with_torch_profiler(tmp_path):
    from recman_tpu_torch.obs import TensorBoardLogger

    tb = TensorBoardLogger(log_dir=str(tmp_path), run_name="run", profile=True)
    tb.trace_on(epoch=0)
    assert tb._tracing
    torch.ones(3).sum()
    tb.trace_off(epoch=0)
    tb.trace_on(epoch=0)  # once per epoch
    assert not tb._tracing
    tb.close()
    assert any(p.name.endswith(".json") for p in (tmp_path / "run" / "hp_0").iterdir())


def test_trainer_raises_on_what_is_not_ported(ml):
    """calibrate returns False for a model with no Dice moments; for one
    whose state holds Dice moments but whose apply takes no moment capture
    (xDeepFM) it warns, as the reference does, and returns False. The
    plain Trainer keeps one step a call and no stacked storage on the CPU.
    (ShardedTrainer's refusals are in tests/test_torch_parallel.py.)"""
    trainer = _small_trainer(ml)
    _, xtr, _, _ = ml["port"]
    assert trainer.calibrate(xtr) is False
    params = dict(trainer.state.params, dnn_dice_mean_0=torch.zeros(4))
    trainer.state = trainer.state._replace(params=params)
    with pytest.warns(UserWarning, match="does not support moment capture"):
        assert trainer.calibrate(xtr) is False
    assert trainer.state.params["dnn_dice_mean_0"].eq(0).all()
    assert trainer.steps_per_dispatch == 1 and not trainer._stacked_active()


def test_trainer_defaults_to_cuda_and_raises_without_a_gpu(ml, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Trainer(XDeepFM(ml["port"][0], HPARAMS), HPARAMS)


@pytest.mark.parametrize("n,bs,seed", [(634, 128, 2019), (256, 128, None)])
def test_batch_indices_match_jax_and_serving_reexports_them(n, bs, seed):
    assert serving.batch_indices is batch_indices
    np.testing.assert_array_equal(batch_indices(n, bs, shuffle_seed=seed),
                                  jax_batch_indices(n, bs, shuffle_seed=seed))


def test_example_runs_on_the_cpu(tmp_path):
    from recman_tpu_torch.examples.xdeepfm_ml import main

    finder, (logloss, auc) = main(frac=0.02, epoch=1, lr_grid=(0.01,), log_dir=str(tmp_path),
                                  device="cpu")
    assert finder.best_model.device.type == "cpu"
    assert 0.0 < logloss < 1.0 and 0.0 < auc < 1.0


# -- the large-batch slice ------------------------------------------------------

LB_HP = {"embedding_size": 8, "cin_cross_layer_units": (8, 8), "cin_dropout": (1, 1, 1),
         "deep_hidden_units": (16, 16), "deep_dropout": (1.0, 1.0, 1.0)}
LB_ROWS, LB_BATCH = 600, 128


def test_fit_with_large_batch_schedule_matches_jax_trainer():
    """Warmup (2 steps from 0) then cosine over the epoch's 5 steps, the
    learning rate linearly scaled from base batch 32, Adam; on the kernels'
    route (the port's K1/K2/K3 twins, JAX's Pallas chain and segment sums
    interpreted), where both sides round alike."""
    from recman_tpu.data import create_criteo_features as jax_criteo_features
    from recman_tpu.data import synthetic_criteo_arrays as jax_criteo_arrays
    from recman_tpu.training import large_batch_schedule as jax_schedule
    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.training import large_batch_schedule

    steps = LB_ROWS // LB_BATCH + 1
    data_j = jax_criteo_arrays(LB_ROWS, num_buckets=50, seed=3)
    data_t = synthetic_criteo_arrays(LB_ROWS, num_buckets=50, seed=3)
    jhp = dict(LB_HP, learning_rate=jax_schedule(1e-3, LB_BATCH, 32, 2, steps))
    jt = JaxTrainer(JaxXDeepFM(jax_criteo_features(num_buckets=50), jhp), jhp,
                    metrics=(JaxLogLoss(),), epoch=1, batch_size=LB_BATCH, random_seed=2019)
    params = {k: np.asarray(v) for k, v in jt.state.params.items()}
    x_j = {k: v for k, v in data_j.items() if k != "y"}
    with _contexts("kernels", jax_emb.fused_grad(True), jax_cin_interact.pallas_cin(True),
                   jax_emb.grad_kernel("segmat")):
        jt.fit(data_j, data_j["y"], random_seed_for_mini_batch=False)
        jax_preds = jt.predict(x_j)
    thp = dict(LB_HP, learning_rate=large_batch_schedule(1e-3, LB_BATCH, 32, 2, steps))
    tt = Trainer(XDeepFM(create_criteo_features(num_buckets=50), thp), thp,
                 metrics=(LogLoss(),), epoch=1, batch_size=LB_BATCH, random_seed=2019,
                 device="cpu")
    p = params_from_jax(params, device="cpu")
    tt.state = tt.state._replace(params=p, opt_state=tt.optimizer.init(p))
    with _contexts("kernels", torch_emb.fused_grad(True), torch_emb.grad_kernel("segmat")):
        tt.fit(data_t, data_t["y"], random_seed_for_mini_batch=False)
        preds = tt.predict({k: v for k, v in data_t.items() if k != "y"})
    assert tt.state.step == steps and int(tt.state.opt_state.count) == steps
    assert abs(tt.last_mean_loss - jt.last_mean_loss) <= LOSS_REL * abs(jt.last_mean_loss)
    np.testing.assert_allclose(preds, jax_preds, rtol=0, atol=PRED_ABS)


def test_trainer_takes_a_schedule_and_an_optimizer_object(ml, tmp_path, monkeypatch):
    """``hparams["learning_rate"]`` may be a schedule and
    ``hparams["optimizer"]`` an optimizer object, as in the reference; the
    TensorBoard hparams registration takes both."""
    from recman_tpu_torch.obs import TensorBoardLogger
    from recman_tpu_torch.training import create_optimizer, warmup_schedule

    schedule = warmup_schedule(1e-2, 2, 5, decay="cosine")
    opt = create_optimizer("lamb", schedule)
    trainer = _small_trainer(ml, hp={"learning_rate": schedule, "optimizer": opt})
    assert trainer.optimizer is opt
    for tbx in (True, False):
        if not tbx:
            monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the JSONL fallback
        tb = TensorBoardLogger(sess_num=0, log_dir=str(tmp_path / str(tbx)), run_name="run")
        tb.configure_hparams(trainer.hparams, trainer.metrics)
        tb.close()
    _, xtr, ytr, _ = ml["port"]
    trainer.fit(xtr, ytr, random_seed_for_mini_batch=False)
    assert np.isfinite(trainer.last_mean_loss) and int(trainer.state.opt_state.count) == 5


def test_criteo_large_batch_example_runs_on_the_cpu():
    from recman_tpu_torch.examples.criteo_large_batch import main

    trainer, (logloss, auc) = main(batch_size=LB_BATCH, rows=LB_ROWS, num_buckets=50,
                                   device="cpu")
    split = int(LB_ROWS * 0.95)
    assert trainer.device.type == "cpu" and trainer.state.step == split // LB_BATCH + 1
    assert callable(trainer.optimizer.learning_rate)
    assert np.isfinite(logloss) and 0.0 <= auc <= 1.0


def test_criteo_example_large_batch_recipe(monkeypatch):
    """``large_batch=True``: batch 65,536 in place of the default 4096, a
    sqrt-scaled peak from base batch 8192, warmup min(12, max(steps // 10,
    1)) then cosine (recorded from the Trainer the example builds); then
    end to end at a batch above 4096, which the recipe keeps."""
    from recman_tpu_torch.examples import criteo_xdeepfm
    from recman_tpu_torch.training import sqrt_scaled_lr, warmup_schedule

    seen = {}

    class Recording(Trainer):
        def __init__(self, model, hparams, **kw):
            seen.update(batch_size=kw["batch_size"], optimizer=hparams["optimizer"])
            raise StopIteration

    monkeypatch.setattr(criteo_xdeepfm, "Trainer", Recording)
    with pytest.raises(StopIteration):
        criteo_xdeepfm.main(rows=400, num_buckets=50, large_batch=True, device="cpu")
    assert seen["batch_size"] == 65_536
    ref = warmup_schedule(sqrt_scaled_lr(0.001, 65_536, 8192), 1, 1, decay="cosine")
    assert [seen["optimizer"].learning_rate(c) for c in range(4)] == [ref(c) for c in range(4)]
    monkeypatch.undo()
    trainer, (logloss, auc) = criteo_xdeepfm.main(rows=400, num_buckets=50, batch_size=4608,
                                                  embedding_size=8, large_batch=True,
                                                  device="cpu")
    assert trainer.batch_size == 4608 and trainer.state.step == 1
    assert np.isfinite(logloss) and 0.0 <= auc <= 1.0
