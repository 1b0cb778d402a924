"""The port's explicit data-parallel steps (recman_tpu_torch/parallel/
train_explicit.py) against the JAX package's on the CPU: the cases of
tests/test_explicit_dp.py.

The JAX side runs in this process on a 2-device mesh of the virtual CPU
devices; the port's side runs once per module in a world of 2 Gloo ranks
(``tests/torch_parallel_cases.py:explicit_dp_world``), started when the
module starts. The port's params are JAX's for ``PRNGKey(0)`` (drawn with
``utils.JaxKey``). The one-rank cases run in this process, on a one-rank
group that ``make_mesh`` starts (a FileStore in a temporary file).

Tolerances, tests/test_explicit_dp.py's: the 6-step Adam traces rtol 1e-3,
atol 1e-4 (per-rank sums in another f32 order); the final params within
2e-2 of each leaf's largest (Adam turns reorder noise on near-zero
gradients into whole steps); one SGD step's params within 2e-5 of it (the
gradients); the eval scan rtol 2e-5, atol 2e-6; the fit's mean loss within
5e-4 and its predictions rtol 5e-3, atol 5e-4. One rank against the port's
plain steps: 1e-6 relative (the same operations; division by 1 is exact).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from recman_tpu.data import create_criteo_features as j_criteo_features
from recman_tpu.data import synthetic_criteo_arrays as j_synthetic
from recman_tpu.models import XDeepFM as JXDeepFM
from recman_tpu.parallel import make_mesh as j_make_mesh
from recman_tpu.parallel.train_explicit import (
    make_dp_eval_scan_explicit as j_eval_scan,
    make_dp_train_step_explicit as j_dp_step,
)
from recman_tpu.training import Trainer as JTrainer
from recman_tpu.training import create_optimizer as j_create_optimizer
from recman_tpu.training import init_state as j_init_state
from recman_tpu.training.train_step import (
    TrainState as JTrainState,
    pack_dataset as j_pack_dataset,
    stack_table_params as j_stack,
)
from recman_tpu.training.trainer import batch_indices
from recman_tpu_torch.parallel import ShardedTrainer, enable_debug_checks, make_mesh
from recman_tpu_torch.parallel.launch import run_world
from recman_tpu_torch.parallel.train_explicit import make_dp_train_step_explicit
from recman_tpu_torch.training import (
    Trainer,
    create_optimizer,
    init_state,
    make_train_step_unrolled,
)
from recman_tpu_torch.utils import JaxKey
from tests import torch_parallel_cases as cases
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

WORLD_TIMEOUT_S = 150


@pytest.fixture(scope="module")
def world():
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(run_world, cases.explicit_dp_world, 2, timeout_s=WORLD_TIMEOUT_S)
        yield future


def ranks(world):
    results = world.result()
    assert [r["rank"] for r in results] == [0, 1]
    return results


@pytest.fixture(scope="module")
def jax_setup():
    fs = j_criteo_features(num_buckets=cases.DP_BUCKETS)
    model = JXDeepFM(fs, cases.DP_HP)
    data, layout = j_pack_dataset(j_synthetic(cases.DP_ROWS, num_buckets=cases.DP_BUCKETS, seed=5))
    data = {k: jnp.asarray(v) for k, v in data.items()}
    idx_mat = batch_indices(cases.DP_ROWS, cases.DP_BATCH, shuffle_seed=0)
    idx_mat = idx_mat[(idx_mat >= 0).all(axis=1)][:cases.DP_STEPS]
    return model, data, layout, idx_mat, j_make_mesh(data=2, devices=jax.devices()[:2])


def _jax_dp(jax_setup, opt, steps, stacked=False):
    model, data, layout, idx_mat, mesh = jax_setup
    state = j_init_state(model, opt, jax.random.PRNGKey(0))
    names = None
    if stacked:
        params, names = j_stack(model, state.params)
        state = JTrainState(params, opt.init(params), state.step, state.rng)
    # one step a call: the same steps as unroll=steps, at a fraction of the
    # reference's compile time on the CPU
    step = j_dp_step(model, opt, mesh, unroll=1, stacked_names=names)
    losses = []
    for i in range(steps):
        state, loss = step(state, data, jnp.asarray(idx_mat[i:i + 1]), layout)
        losses.append(np.asarray(loss))
    return np.concatenate(losses), state


def _params_within(got, want, frac):
    for k, b in want.items():
        a, b = np.asarray(got[k]), np.asarray(b)
        assert np.abs(a - b).max() <= frac * (np.abs(b).max() + 1e-6), k


def test_trajectory_matches_the_reference(world, jax_setup):
    losses, state = _jax_dp(jax_setup, j_create_optimizer("adam", 1e-3), cases.DP_STEPS)
    results = ranks(world)
    for r in results:
        got_losses, got_params = r["trajectory"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-3, atol=1e-4)
        _params_within(got_params, state.params, 2e-2)
    # the replicas apply identical updates
    for k, v in results[0]["trajectory"][1].items():
        np.testing.assert_array_equal(v, results[1]["trajectory"][1][k], err_msg=k)


def test_stacked_storage_matches_the_reference(world, jax_setup):
    from recman_tpu.training.train_step import unstack_table_params

    losses, state = _jax_dp(jax_setup, j_create_optimizer("adam", 1e-3), cases.DP_STEPS,
                            stacked=True)
    want = unstack_table_params(jax_setup[0], state.params)
    for r in ranks(world):
        got_losses, got_params = r["stacked"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-3, atol=1e-4)
        _params_within(got_params, want, 2e-2)


def test_stacked_matches_the_single_rank_stacked_step(world):
    for r in ranks(world):
        np.testing.assert_allclose(r["stacked"][0], r["stacked_single"], rtol=1e-3, atol=1e-4)


def test_eval_scan_matches_the_reference(world, jax_setup):
    model, data, layout, idx_mat, mesh = jax_setup
    state = j_init_state(model, j_create_optimizer("adam", 1e-3), jax.random.PRNGKey(0))
    want = np.asarray(j_eval_scan(model, mesh)(state.params, data, jnp.asarray(idx_mat[:4]), None,
                                               False, layout))
    for r in ranks(world):
        np.testing.assert_allclose(r["eval"], want, rtol=2e-5, atol=2e-6)


def test_sgd_one_step_grad_parity(world, jax_setup):
    """One SGD step: the param delta is lr * grad. The reference's bound,
    2e-5, holds the DP step to the port's own one-rank step (the same
    framework, as the reference holds its DP step to its unsharded one: a
    double-counted sum shows at 1e-3); against JAX's DP step the port's
    gradient bound across the frameworks, 1e-3 (tests/test_torch_training.py:
    a cancelling sum such as cin_bias_0's lands 3.6e-5 apart already
    between the two unsharded steps)."""
    _, state = _jax_dp(jax_setup, j_create_optimizer("sgd", 0.1), 1)
    for r in ranks(world):
        _params_within(r["sgd"], r["sgd_single"], 2e-5)
        _params_within(r["sgd"], state.params, 1e-3)


def test_live_dropout_runs_and_differs(world):
    for r in ranks(world):
        assert np.all(np.isfinite(r["dropout"]))
        assert not np.allclose(r["dropout"], r["trajectory"][0][:2])
    # each data rank draws its own masks; the loss is the data group's sum
    np.testing.assert_array_equal(ranks(world)[0]["dropout"], ranks(world)[1]["dropout"])


def test_sharded_trainer_auto_takes_explicit_dp_and_fits(world):
    fs = j_criteo_features(num_buckets=cases.AUTO_BUCKETS)
    raw = j_synthetic(cases.AUTO_ROWS, num_buckets=cases.AUTO_BUCKETS, seed=9)
    x, y = cases.split_xy(raw)
    t = JTrainer(JXDeepFM(fs, cases.DP_HP), epoch=1, batch_size=64, random_seed=7)
    t.fit(dict(raw), np.asarray(y), random_seed_for_mini_batch=False)
    want = t.predict(dict(raw))
    for r in ranks(world):
        assert r["auto_route"] == (True, True)
        assert abs(r["auto_loss"] - t.last_mean_loss) < 5e-4, (r["auto_loss"], t.last_mean_loss)
        np.testing.assert_allclose(r["auto_predict"], want, rtol=5e-3, atol=5e-4)


def test_supported_gate(world):
    for r in ranks(world):
        assert r["gate"] == (True, False, False)


# -- one rank, in this process -----------------------------------------------------


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank group, as a plain single process gets from make_mesh()."""
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_one_rank_matches_the_plain_steps(one_rank):
    model, data, layout, idx_mat = cases.dp_setup()
    adam = create_optimizer("adam", 1e-3)
    ref = make_train_step_unrolled(model, adam, cases.DP_STEPS)(
        init_state(model, adam, JaxKey(0), device="cpu"), data, torch.as_tensor(idx_mat), layout)
    got = make_dp_train_step_explicit(model, adam, one_rank, unroll=cases.DP_STEPS)(
        init_state(model, adam, JaxKey(0), device="cpu"), data, torch.as_tensor(idx_mat), layout)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), rtol=1e-6)
    for k, v in ref[0].params.items():
        np.testing.assert_allclose(got[0].params[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_one_rank_sharded_trainer_matches_the_plain_trainer(one_rank):
    """ShardedTrainer(model) with no mesh: the one-rank group, the explicit
    DP route, the plain Trainer's fit_on_batch trace."""
    fs = cases.create_criteo_features(num_buckets=cases.AUTO_BUCKETS)
    x, y = cases.split_xy(cases.synthetic_criteo_arrays(cases.AUTO_ROWS,
                                                        num_buckets=cases.AUTO_BUCKETS, seed=9))
    traces = []
    for cls in (Trainer, ShardedTrainer):
        t = cls(cases.XDeepFM(fs, cases.DP_HP), epoch=1, batch_size=64, random_seed=7,
                device="cpu")
        t.state = init_state(t.model, t.optimizer, JaxKey(7), device="cpu")
        dev, layout = t._to_device(x, y)
        idx = t._batch_index_matrix(cases.AUTO_ROWS, shuffle_seed=7)
        traces.append([float(t.fit_on_batch(dev, idx[i], layout)) for i in range(4)])
    assert t._explicit_dp and t.mesh.shape == {"data": 1, "model": 1}
    np.testing.assert_allclose(traces[1], traces[0], rtol=1e-6)


def test_debug_checks_raise_on_a_nan(one_rank):
    model, data, layout, idx_mat = cases.dp_setup()
    sgd = create_optimizer("sgd", 0.1)
    state = init_state(model, sgd, JaxKey(0), device="cpu")
    params = dict(state.params, linear_w0=torch.full((1,), float("nan")))
    step = make_dp_train_step_explicit(model, sgd, one_rank)
    step(state._replace(params=params), data, torch.as_tensor(idx_mat[:1]), layout)  # off: runs
    enable_debug_checks(nans=True)
    try:
        with pytest.raises(FloatingPointError, match="NaN"):
            step(state._replace(params=params), data, torch.as_tensor(idx_mat[:1]), layout)
    finally:
        enable_debug_checks(nans=False)
