"""The port's checkpoints (recman_tpu_torch/ckpt, Trainer.save/restore,
convert.state_from_jax, Predictor.from_checkpoint) on the CPU, against
the JAX package where it has a counterpart.

- Save, restore and continue is bit-equal (``torch.equal``) to the run
  that never stopped, for every optimizer of the menu, for
  ``lamb_partitioned`` and under a schedule, with dropout live (the
  generator is restored too).
- The sidecars are byte-equal to those of the JAX ``Trainer.save`` for the
  same model and hparams.
- A JAX state carried across by ``state_from_jax``: the next update of
  every optimizer equals optax's within ``test_torch_optim.py``'s bounds
  (1e-6 of the largest element, 1e-3 for a bf16 moment); a JAX Trainer's
  run of 3 steps continued 3 steps in the port matches JAX's own
  continuation within ``test_fit_matches_jax_trainer``'s bounds (1e-4
  relative loss, 1e-4 absolute predictions).
- ``Predictor.from_checkpoint`` against JAX's on the same params, 1e-5
  (``test_torch_xdeepfm.py``'s bound for the same forward).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import recman_tpu
import recman_tpu_torch
from recman_tpu.ckpt import warm_start_embeddings as jax_warm_start
from recman_tpu.data import create_criteo_features as jax_criteo_features
from recman_tpu.data import synthetic_criteo_arrays as jax_criteo_arrays
from recman_tpu.models import XDeepFM as JaxXDeepFM
from recman_tpu.serving import Predictor as JaxPredictor
from recman_tpu.training import Trainer as JaxTrainer
from recman_tpu.training import lr_schedule as jax_sched
from recman_tpu.training import train_step as jax_ts
from recman_tpu_torch.ckpt import (
    load_feat_dict,
    restore_checkpoint,
    save_checkpoint,
    warm_start_embeddings,
)
from recman_tpu_torch.ckpt.checkpoint import STATE_DIR, STATE_FILE, _flatten
from recman_tpu_torch.convert import params_from_jax, state_from_jax
from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
from recman_tpu_torch.models import MODEL_REGISTRY, XDeepFM
from recman_tpu_torch.serving import Predictor
from recman_tpu_torch.training import (
    LogLoss,
    Trainer,
    TrainState,
    batch_indices,
    create_optimizer,
)
from recman_tpu_torch.training import lr_schedule as sched
from tests.test_torch_xdeepfm import _schema
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

NAMES = ["adam", "adam_bf16m", "adagrad", "sgd", "momentum", "lamb", "rowwise_adam"]
BF16_MOMENTS = ("adam_bf16m", "rowwise_adam")
HP = {"embedding_size": 8, "cin_cross_layer_units": (8, 8), "cin_dropout": (1, 1, 1),
      "deep_hidden_units": (16, 16), "deep_dropout": (1.0, 1.0, 1.0)}
BUCKETS, ROWS, BATCH = 50, 600, 128
LOSS_REL, PRED_ABS = 1e-4, 1e-4


@pytest.fixture(scope="module")
def criteo():
    data = synthetic_criteo_arrays(ROWS, num_buckets=BUCKETS, seed=3)
    return data, {k: v for k, v in data.items() if k != "y"}


def _trainer(optimizer="adam", lr=1e-2, hp=None, seed=2019, epoch=1):
    hpx = {**HP, **(hp or {}), "optimizer": optimizer, "learning_rate": lr}
    return Trainer(XDeepFM(create_criteo_features(num_buckets=BUCKETS), hpx), hpx,
                   metrics=(LogLoss(),), epoch=epoch, batch_size=BATCH, random_seed=seed,
                   device="cpu")


def _steps(trainer, data, n, seed=7):
    dev, layout = trainer._to_device(data)
    idx = batch_indices(len(data["y"]), BATCH, shuffle_seed=seed)
    for i in range(n):
        trainer.fit_on_batch(dev, idx[i % idx.shape[0]], layout)


def _assert_states_equal(a: TrainState, b: TrainState):
    assert list(a.params) == list(b.params)
    for k in a.params:
        assert a.params[k].dtype == b.params[k].dtype and torch.equal(a.params[k], b.params[k]), k
    fa, fb = _flatten(a.opt_state), _flatten(b.opt_state)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y), path
        else:
            assert x == y, path
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _optimizer_case(name):
    """(optimizer or name, lr) of a case: a menu name with a float lr,
    lamb_partitioned and adam under a warmup-then-cosine schedule."""
    if name == "lamb_partitioned":
        return sched.lamb_partitioned(sched.warmup_schedule(1e-2, 2, 6, decay="cosine")), 1e-2
    if name == "adam+schedule":
        return "adam", sched.warmup_schedule(1e-2, 2, 6, decay="cosine")
    return name, 1e-2


@pytest.mark.parametrize("name", NAMES + ["lamb_partitioned", "adam+schedule"])
def test_save_restore_continues_bit_equal(criteo, tmp_path, name):
    """2 steps, save, 2 more; a fresh Trainer (another seed) restored from
    the checkpoint and given the same 2 steps ends bit-equal, generator
    included (DNN dropout live)."""
    data, _ = criteo
    opt, lr = _optimizer_case(name)
    hp = {"deep_dropout": (0.5, 0.5, 0.5)}
    a = _trainer(opt, lr, hp)
    _steps(a, data, 2, seed=1)
    a.save(tmp_path / "ck")
    gen = torch.Generator()
    gen.set_state(a.state.generator.get_state())  # dropout advances the live one in place
    saved = a.state._replace(generator=gen)
    _steps(a, data, 2, seed=2)
    b = _trainer(opt, lr, hp, seed=5)
    b.restore(tmp_path / "ck")
    _assert_states_equal(saved, b.state)
    _steps(b, data, 2, seed=2)
    _assert_states_equal(a.state, b.state)
    assert b.state.step == 4 and int(_flatten(b.state.opt_state)[0][1]) == 4  # the count


def test_sidecars_are_byte_equal_to_jax(synthetic_df, tmp_path):
    hp = {**HP, "learning_rate": 0.01, "optimizer": "adam"}
    jt = JaxTrainer(JaxXDeepFM(_schema(recman_tpu, synthetic_df), hp), hp, batch_size=8)
    tt = Trainer(XDeepFM(_schema(recman_tpu_torch, synthetic_df), hp), hp, batch_size=8,
                 device="cpu")
    jt.save(tmp_path / "jax")
    tt.save(tmp_path / "port")
    for name in ("hparams.json", "feat_dict.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    fs = load_feat_dict(tmp_path / "port")
    assert [(f.name, f.feat_size) for f in fs.values()] == \
        [(f.name, f.feat_size) for f in tt.model.feat_dict.values()]
    assert json.loads((tmp_path / "port" / "hparams.json").read_text())["cin_cross_layer_units"] \
        == "(8, 8)"


def test_criteo_schema_takes_the_pickle_sidecar(tmp_path):
    """The Criteo schema's log1p scaler has no JSON form: the pickle
    fallback, as in the reference, and it loads back."""
    t = _trainer()
    t.save(tmp_path)
    assert (tmp_path / "feat_dict.pkl").exists() and not (tmp_path / "feat_dict.json").exists()
    assert list(load_feat_dict(tmp_path)) == list(t.model.feat_dict)


def test_state_file_is_weights_only_and_restore_names_what_differs(tmp_path):
    t = _trainer("rowwise_adam")
    t.save(tmp_path)
    blob = torch.load(tmp_path / STATE_DIR / STATE_FILE, weights_only=True)
    assert set(blob) == {"params", "opt_state", "step", "generator"}
    assert blob["generator"]["device_type"] == "cpu"
    assert blob["opt_state"][("inner_states", "table", "mu", "dnn_w")] == "MaskedNode"
    assert blob["opt_state"][("inner_states", "rest", "mu", "C1_feat_embed")] == "MaskedNode"
    assert os.listdir(tmp_path / STATE_DIR) == [STATE_FILE]  # the temporary name is gone

    wider = _trainer("rowwise_adam", hp={"embedding_size": 4})
    with pytest.raises(ValueError, match="param 'C1_feat_embed' has shape"):
        restore_checkpoint(tmp_path, wider.state)
    fewer = TrainState({k: v for k, v in t.state.params.items() if k != "dnn_w"},
                       t.state.opt_state, 0, None)
    with pytest.raises(ValueError, match="'dnn_w', which the template lacks"):
        restore_checkpoint(tmp_path, fewer)
    with pytest.raises(ValueError, match="checkpoint has no optimizer state .'count'"):
        restore_checkpoint(tmp_path, _trainer("adam").state)
    _trainer("adam").save(tmp_path / "adam")
    with pytest.raises(ValueError, match="'mu', 'C1_feat_embed'.*dtype torch.float32 in the "
                                         "checkpoint, torch.bfloat16"):
        restore_checkpoint(tmp_path / "adam", _trainer("adam_bf16m").state)


def test_generator_restores_only_onto_its_device_type(tmp_path):
    """A checkpoint whose generator is of another device type (written on
    the card) restores params, moments and step into a template without a
    generator; with one, Trainer.restore raises and says so."""
    t = _trainer()
    t.save(tmp_path)
    path = tmp_path / STATE_DIR / STATE_FILE
    blob = torch.load(path, weights_only=True)
    blob["generator"]["device_type"] = "cuda"
    torch.save(blob, path)
    fresh = _trainer(seed=9)
    with pytest.raises(ValueError, match="cuda dropout generator.*cpu"):
        fresh.restore(tmp_path)
    state = restore_checkpoint(tmp_path, fresh.state._replace(generator=None))
    assert state.generator is None
    _assert_states_equal(t.state._replace(generator=torch.Generator()),
                         state._replace(generator=torch.Generator()))


def _jax_optimizer(name, lr):
    if name == "lamb_partitioned":
        return jax_sched.lamb_partitioned(lr)
    return jax_ts.create_optimizer(name, lr)


@pytest.mark.parametrize("kind", ["float", "schedule"])
@pytest.mark.parametrize("name", NAMES + ["lamb_partitioned"])
def test_state_from_jax_reads_every_optax_state(name, kind):
    """2 optax updates, the state carried across, then the next update on
    both sides."""
    rs = np.random.RandomState(0)
    params = {"a_feat_embed": (0.1 * rs.randn(20, 4)).astype(np.float32),
              "w": rs.randn(6, 3).astype(np.float32), "v": rs.randn(3).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    if kind == "float":
        lr_t = lr_j = 1e-2
    else:
        lr_t = sched.warmup_schedule(1e-2, 2, 5, decay="cosine")
        lr_j = jax_sched.warmup_schedule(1e-2, 2, 5, decay="cosine")
    jopt = _jax_optimizer(name, lr_j)
    topt = sched.lamb_partitioned(lr_t) if name == "lamb_partitioned" else \
        create_optimizer(name, lr_t)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init(jp)
    for g in grads[:2]:
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, ju)
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    state = state_from_jax(np_params, jax.tree.map(np.asarray, jst), jnp.asarray(2), topt,
                           device="cpu", seed=3)
    assert state.step == 2 and state.generator.device.type == "cpu"
    counts = [x for p, x in _flatten(state.opt_state) if p[-1] == "count"]
    assert counts and all(int(c) == 2 and c.dtype == torch.int32 for c in counts)
    ju, _ = jopt.update({k: jnp.asarray(v) for k, v in grads[2].items()}, jst, jp)
    tu, _ = topt.update({k: torch.from_numpy(v) for k, v in grads[2].items()},
                        state.opt_state, state.params)
    tol = 1e-3 if name in BF16_MOMENTS else 1e-6
    for k in params:
        ref = np.asarray(ju[k], dtype=np.float64)
        assert np.abs(tu[k].numpy() - ref).max() <= tol * np.abs(ref).max(), k


def test_state_from_jax_continues_a_jax_trainer_run(criteo):
    """Adam under warmup then cosine to a peak of 1e-3 (the Trainer tests'
    rate): 3 JAX steps, the state carried across, 3 more steps on each
    side."""
    data_t, x_t = criteo
    data_j = jax_criteo_arrays(ROWS, num_buckets=BUCKETS, seed=3)
    jhp = {**HP, "learning_rate": jax_sched.warmup_schedule(1e-3, 2, 6, decay="cosine")}
    thp = {**HP, "learning_rate": sched.warmup_schedule(1e-3, 2, 6, decay="cosine")}
    jt = JaxTrainer(JaxXDeepFM(jax_criteo_features(num_buckets=BUCKETS), jhp), jhp,
                    batch_size=BATCH, random_seed=2019)
    jdev, jlayout = jt._to_device(data_j, data_j["y"])
    idx = batch_indices(ROWS, BATCH, shuffle_seed=4)
    for i in range(3):
        jt.fit_on_batch(jdev, idx[i], jlayout)
    jstate = jax.tree.map(np.asarray, jt.state)
    tt = Trainer(XDeepFM(create_criteo_features(num_buckets=BUCKETS), thp), thp,
                 batch_size=BATCH, device="cpu")
    tt.state = state_from_jax(jstate.params, jstate.opt_state, jstate.step, tt.optimizer,
                              device="cpu")
    tdev, tlayout = tt._to_device(data_t)
    for i in range(3, 6):
        jl = float(jt.fit_on_batch(jdev, idx[i % idx.shape[0]], jlayout))
        tl = float(tt.fit_on_batch(tdev, idx[i % idx.shape[0]], tlayout))
        assert abs(tl - jl) <= LOSS_REL * abs(jl), i
    assert tt.state.step == int(jt.state.step) == 6
    np.testing.assert_allclose(tt.predict(x_t), jt.predict(x_t), rtol=0, atol=PRED_ABS)


def test_predictor_from_checkpoint_matches_jax(synthetic_df, tmp_path):
    hp = {**HP, "learning_rate": 0.01}
    jt = JaxTrainer(JaxXDeepFM(_schema(recman_tpu, synthetic_df), hp), hp, batch_size=8)
    jt.save(tmp_path / "jax")
    tt = Trainer(XDeepFM(_schema(recman_tpu_torch, synthetic_df), hp), hp, batch_size=8,
                 device="cpu")
    tt.state = tt.state._replace(
        params=params_from_jax({k: np.asarray(v) for k, v in jt.state.params.items()},
                               device="cpu"))
    tt.save(tmp_path / "port")
    jp = JaxPredictor.from_checkpoint(tmp_path / "jax", "xdeepfm", hparams=hp, batch_size=8)
    tp = Predictor.from_checkpoint(tmp_path / "port", "xdeepfm", hparams=hp, batch_size=8,
                                   device="cpu")
    assert MODEL_REGISTRY["xdeepfm"] is XDeepFM and tp.device.type == "cpu"
    np.testing.assert_allclose(tp.predict(synthetic_df), jp.predict(synthetic_df), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tp.predict(synthetic_df), tt.predict(synthetic_df))
    # every model of the zoo is registered: an AutoInt on this xDeepFM
    # checkpoint is built, and the check of its params refuses it; an
    # unknown name raises as the reference's registry does
    with pytest.raises(ValueError, match="checkpoint has no param 'autoint_0_wq'"):
        Predictor.from_checkpoint(tmp_path / "port", "autoint", hparams=hp, device="cpu")
    with pytest.raises(KeyError, match="no_such_model"):
        Predictor.from_checkpoint(tmp_path / "port", "no_such_model", device="cpu")


def test_warm_start_embeddings_matches_jax():
    """The byte-copied transfer on host params: a re-fitted vocabulary
    (values dropped, added, every id shifted) and a hashed table."""
    import pandas as pd

    rs = np.random.RandomState(0)

    def schema(pkg, values):
        df = pd.DataFrame({"u": values, "h": values, "d": rs.randn(len(values))})
        fs = pkg.FeatureSet()
        fs["u"] = pkg.SparseFeat("u")
        fs["h"] = pkg.HashedSparseFeat("h", num_buckets=64)
        fs["d"] = pkg.DenseFeat("d")
        fs.initialize(df)
        return fs

    old_vals = [f"v{i}" for i in range(20)]
    new_vals = [f"v{i}" for i in range(5, 20)] + [f"w{i}" for i in range(10)]
    t_old, t_new = schema(recman_tpu_torch, old_vals), schema(recman_tpu_torch, new_vals)
    j_old, j_new = schema(recman_tpu, old_vals), schema(recman_tpu, new_vals)
    old = {k: v.numpy() for k, v in XDeepFM(t_old, HP).init_params(
        torch.Generator().manual_seed(1), "cpu").items()}
    new_model = XDeepFM(t_new, HP)
    fresh = {k: v.numpy() for k, v in new_model.init_params(
        torch.Generator().manual_seed(2), "cpu").items()}
    got = warm_start_embeddings(fresh, t_new, old, t_old)
    want = jax_warm_start(fresh, j_new, old, j_old)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    v5_old = t_old["u"].encoder.transform(["v5"])[0]
    v5_new = t_new["u"].encoder.transform(["v5"])[0]
    np.testing.assert_array_equal(got["u_feat_embed"][v5_new], old["u_feat_embed"][v5_old])
    params = params_from_jax(got, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in t_new.transform(
        pd.DataFrame({"u": new_vals, "h": new_vals, "d": rs.randn(25)})).items()}
    assert torch.isfinite(new_model.apply(params, batch)).all()


def test_best_model_finder_saves_a_checkpoint_that_restores(criteo, tmp_path):
    from recman_tpu_torch.obs import BestModelFinder

    data, x = criteo
    finder = BestModelFinder(save_model=True, save_dir=str(tmp_path / "best"))
    t = _trainer(epoch=1)
    t.fit(x, data["y"], epoch_callback=finder, random_seed_for_mini_batch=False)
    assert finder.best_model is t and (tmp_path / "best" / "df_sample.pkl").exists()
    fresh = _trainer(seed=11)
    fresh.restore(tmp_path / "best")
    _assert_states_equal(t.state, fresh.state)


def test_save_checkpoint_of_a_bare_state(tmp_path):
    """A state without a generator and sidecars: the state file alone."""
    t = _trainer("sgd")
    state = t.state._replace(generator=None, step=3)
    save_checkpoint(tmp_path, state)
    assert os.listdir(tmp_path) == [STATE_DIR]
    back = restore_checkpoint(tmp_path, t.state._replace(generator=None))
    assert back.step == 3 and back.opt_state.acc is None
    assert all(torch.equal(back.params[k], v) for k, v in state.params.items())
