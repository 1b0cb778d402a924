"""The port's parallel layer (recman_tpu_torch/parallel) against the JAX
package's on the CPU: the cases of tests/test_parallel.py.

The JAX side runs in this process on a (2, 2) and a (1, 4) mesh of the
virtual CPU devices tests/conftest.py provides. The port's side runs once
per module in a world of 4 Gloo ranks (``run_world``, one thread a rank,
``tests/torch_parallel_cases.py:parallel_world``), started when the module
starts and read by each test; rank r stands for JAX device r
(``rank = d * model + m``). Both sides build the same inputs from the same
seeds; the port's params come from ``utils.JaxKey`` (the reference's
params for the same key, within 2.4e-7).

Tolerances: exchanged rows are copies (rtol 1e-6); gradients rtol 1e-5
(atol 1e-6 for the dedup's, as the reference's test); ShardedTrainer's
6-step Adam traces and final params rtol 1e-3, atol 1e-4 (f32 sums in
another order, tests/test_explicit_dp.py's bounds); the counted bytes of
one step equal ``collective_traffic_model``'s.

The rest of the layer (``PARITY_CASES``: Dice over the data group, TP
towers, DIEN's auxiliary loss, QR, Lamb) is held to JAX's ShardedTrainer
on the (2, 2) mesh for 4 steps at the same bounds, with Adagrad, or Lamb
at lr 1e-3 (Lamb's Adam update turns reorder noise on near-zero
gradients into whole steps at lr 1e-2, as Adam does: ROADMAP.md §3). The
zoo and sequence models, ``fit_stream`` and the preempted runs are held
to the port's plain Trainer and to uninterrupted runs in the same world;
the JAX references are computed while the ranks run.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from recman_tpu.data import create_criteo_features as j_criteo_features
from recman_tpu.features import DenseFeat as JDenseFeat
from recman_tpu.features import FeatureSet as JFeatureSet
from recman_tpu.features import SparseFeat as JSparseFeat
from recman_tpu.models import DeepFM as JDeepFM
from recman_tpu.models import XDeepFM as JXDeepFM
from recman_tpu.parallel import ShardedTrainer as JShardedTrainer
from recman_tpu.parallel import dedup_embedding_lookup as j_dedup
from recman_tpu.parallel import make_mesh as j_make_mesh
from recman_tpu.parallel import param_specs as j_param_specs
from recman_tpu.parallel import place_params as j_place_params
from recman_tpu.parallel import sharded_embedding_lookup as j_psum
from recman_tpu.parallel.shard_lookup import capacity_from_sample as j_capacity_from_sample
from recman_tpu.parallel.shard_lookup import default_capacity as j_default_capacity
from recman_tpu.training import LogLoss as JLogLoss
from recman_tpu_torch.parallel import (
    ShardedTrainer,
    capacity_from_sample,
    pad_vocab_for_mesh,
    param_specs,
)
from recman_tpu_torch.parallel.launch import run_world
from recman_tpu_torch.parallel.shard_lookup import default_capacity
from recman_tpu_torch.parallel.traffic import collective_traffic_model
from tests import torch_parallel_cases as cases
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

WORLD_TIMEOUT_S = 150


def _ranked_hot_data(n=1024, vocab_classes=2047):
    """tests/test_parallel.py's Zipf-RANKED string features."""
    rs = np.random.RandomState(0)
    fit_vals = [f"v{r:05d}" for r in range(vocab_classes)]
    cols = {}
    for c in range(4):
        ranks = np.minimum(rs.zipf(1.3, n), vocab_classes - 1)
        cols[f"C{c}"] = [f"v{r:05d}" for r in ranks]
    df = pd.DataFrame(cols)
    fit_df = pd.DataFrame({k: fit_vals for k in cols})
    df_all = pd.concat([fit_df, df], ignore_index=True)
    return df_all, df, rs.randint(0, 2, n).astype(np.float32)


def _encodings():
    """name -> (JAX FeatureSet, (feature sizes, encoded columns, y)) for the
    shuffled and the ranked vocabularies."""
    df_all, df, y = _ranked_hot_data()
    out = {}
    for name, shuffle in (("shuffled", 7), ("ranked", None)):
        fs = JFeatureSet()
        for c in range(4):
            fs[f"C{c}"] = JSparseFeat(f"C{c}")
        fs.initialize(df_all, shuffle_vocab=shuffle)
        cols = {k: np.asarray(v) for k, v in fs.transform(df).items()}
        out[name] = (fs, ({f.name: f.feat_size for f in fs.sparse_feats}, cols, y))
    return out


@pytest.fixture(scope="module")
def encodings():
    return _encodings()


def _qr_frame():
    """tests/test_qr_embedding.py's sharded case's rows and labels."""
    rs = np.random.RandomState(0)
    df = pd.DataFrame({"u": [f"u{i}" for i in rs.randint(0, cases.QR_VOCAB, cases.QR_ROWS)],
                       "d": rs.randn(cases.QR_ROWS)})
    return df, rs.randint(0, 2, cases.QR_ROWS).astype(np.float32)


@pytest.fixture(scope="module")
def world(encodings, mesh22, mesh14):
    """The port's side, started once, and the JAX side's references,
    computed here while the ranks run: (the ranks' future, {name:
    reference}). Each test waits for the ranks."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(run_world, cases.parallel_world, 4,
                             args=({k: v[1] for k, v in encodings.items()}, _qr_frame()),
                             timeout_s=WORLD_TIMEOUT_S)
        refs = {"traces": _jax_traces(mesh22), "skew": _jax_skew(mesh14),
                "parity": _jax_parity(mesh22)}
        yield future, refs


def ranks(world):
    results = world[0].result()
    assert [r["coords"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    return results


@pytest.fixture(scope="module")
def mesh22():
    return j_make_mesh(data=2, model=2, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def mesh14():
    return j_make_mesh(data=1, model=4, devices=jax.devices()[:4])


def _sharded(mesh, table):
    return jax.device_put(jnp.asarray(table), NamedSharding(mesh, P("model", None)))


def _assemble(results, key_fn, sharded=True):
    """A data-sharded (d-major) output from the model-rank-0 ranks; every
    model rank must hold the same."""
    by_d = {}
    for r in results:
        d, m = r["coords"]
        got = key_fn(r)
        if m == 0:
            by_d[d] = got
        else:
            np.testing.assert_array_equal(got, by_d[d])
    if not sharded:
        np.testing.assert_array_equal(by_d[0], by_d[1])
        return by_d[0]
    return np.concatenate([by_d[d] for d in sorted(by_d)])


def _table_grad(results, name):
    """A table's full gradient from the model ranks' summed blocks."""
    blocks = {}
    for r in results:
        d, m = r["coords"]
        blocks.setdefault(m, r["lookups"][name])
        np.testing.assert_array_equal(r["lookups"][name], blocks[m])
    return np.concatenate([blocks[m] for m in sorted(blocks)])


# -- placement and mesh ---------------------------------------------------------


TP_PARAMS = {"dnn_layer_0_weights": (400, 400), "dnn_layer_0_bias": (400,),
             "dnn_layer_1_weights": (400, 400), "dnn_layer_1_bias": (400,),
             "dnn_layer_2_weights": (400, 66), "top_dnn_layer_0_bias": (100_000,),
             "top_dnn_layer_1_bias": (100_000,), "dnn_w": (400, 1),
             "asp_layer_0_weights": (400, 400)}


@pytest.mark.parametrize("tp", [None, 100_000, 1000])
def test_param_specs_match_the_reference(tp):
    params = {"C1_feat_embed": np.zeros((100_000, 8), np.float32),
              "small_feat_embed": np.zeros((50, 8), np.float32),
              "linear_w": np.zeros((2_600_000, 1), np.float32),
              "C2_feat_embed_q": np.zeros((60_000, 8), np.float32),
              "C3_feat_bias": np.zeros((70_000,), np.float32),
              **{k: np.zeros(v, np.float32) for k, v in TP_PARAMS.items()}}
    want = j_param_specs({k: jnp.asarray(v) for k, v in params.items()}, 50_000, tp)
    got = param_specs(params, 50_000, tp)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["C1_feat_embed"] == ("model", None)
    assert pad_vocab_for_mesh(100, 8) == 104 and pad_vocab_for_mesh(96, 8) == 96
    if tp is None:
        assert got["dnn_layer_0_weights"] == ()
    elif tp == 100_000:  # the bench DNN's (400, 400) pair; no bias crosses
        assert got["dnn_layer_0_weights"] == (None, "model")
        assert got["dnn_layer_1_weights"] == ("model", None)
        assert got["dnn_layer_0_bias"] == got["dnn_layer_1_bias"] == ()
        assert got["top_dnn_layer_0_bias"] == ("model",) and got["top_dnn_layer_1_bias"] == ()
    assert got["asp_layer_0_weights"] == got["dnn_w"] == ()


def test_indivisible_dims_fall_back():
    """tests/test_parallel.py's case: a (100, 66) layer is column-sharded by
    spec, replicated at placement on a 4-wide model axis; the port resolves
    the fallback into the specs it keeps."""
    from recman_tpu.parallel.sharding import place_params as j_place
    from recman_tpu_torch.parallel.sharding import resolve_specs

    params = {"dnn_layer_0_weights": np.zeros((100, 66), np.float32),
              "dnn_layer_1_weights": np.zeros((64, 64), np.float32)}
    specs = param_specs(params, tp_dense_threshold=100)
    assert specs["dnn_layer_0_weights"] == (None, "model")
    mesh24 = j_make_mesh(data=2, model=4, devices=jax.devices()[:8])
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    placed = j_place(jparams, mesh24, j_param_specs(jparams, tp_dense_threshold=100))
    want = {k: tuple(v.sharding.spec) for k, v in placed.items()}
    got = resolve_specs(specs, params, 4)
    assert got == want == {"dnn_layer_0_weights": (), "dnn_layer_1_weights": ("model", None)}
    from recman_tpu_torch.parallel import place_params

    blocks = place_params(params, _FakeMesh(2, 4, (1, 3)), got)
    assert blocks["dnn_layer_0_weights"].shape == (100, 66)
    assert blocks["dnn_layer_1_weights"].shape == (16, 64)


def test_place_params_blocks_match_the_reference(world, mesh22):
    params = cases.placement_params()
    want = j_place_params({k: jnp.asarray(v) for k, v in params.items()}, mesh22,
                          row_shard_threshold=256)
    for r in ranks(world):
        d, m = r["coords"]
        place = r["placement"]
        assert place["specs"] == {k: tuple(v.sharding.spec) for k, v in want.items()}
        for name, block in place["blocks"].items():
            full = np.asarray(want[name])
            if place["specs"][name]:
                rows = full.shape[0] // 2
                full = full[m * rows:(m + 1) * rows]
            np.testing.assert_array_equal(block, full, err_msg=name)


def test_make_mesh_factorization_errors(world):
    with pytest.raises(AssertionError) as e33:
        j_make_mesh(data=3, model=3, devices=jax.devices()[:4])
    with pytest.raises(AssertionError) as e3:
        j_make_mesh(model=3, devices=jax.devices()[:4])
    for r in ranks(world):
        assert r["refusals"]["mesh_factorization"] == f"ValueError: {e33.value}"
        assert r["refusals"]["model_factorization"] == f"ValueError: {e3.value}"


# -- the exchanges at (2, 2) -------------------------------------------------------


def test_psum_exchange_rows_and_grads(world, mesh22):
    results = ranks(world)
    table, ids = cases.lookup_inputs(1000, 8, 64, 0)
    want = np.asarray(jax.jit(lambda t, i: j_psum(t, i, mesh22))(_sharded(mesh22, table), ids))
    got = _assemble(results, lambda r: r["lookups"]["psum_rows"])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, table[ids], rtol=1e-6)

    table1, ids1 = cases.lookup_inputs(96, 4, 16, 1)
    w = jnp.asarray(cases.grad_weights())
    g_jax = jax.jit(jax.grad(lambda t: jnp.sum(j_psum(t, jnp.asarray(ids1), mesh22) * w)))(
        _sharded(mesh22, table1))
    dense = np.zeros_like(table1)
    np.add.at(dense, ids1, np.asarray(w))
    got = _table_grad(results, "psum_grad")
    np.testing.assert_allclose(got, np.asarray(g_jax), rtol=1e-5)
    np.testing.assert_allclose(got, dense, rtol=1e-5)


def test_dedup_exchange_uniform_and_zipf(world, mesh22):
    results = ranks(world)
    table, ids = cases.lookup_inputs(1000, 8, 64, 0)
    sharded = _sharded(mesh22, table)
    want = np.asarray(jax.jit(lambda t, i: j_dedup(t, i, mesh22))(sharded, ids))
    np.testing.assert_allclose(_assemble(results, lambda r: r["lookups"]["dedup_rows"]), want,
                               rtol=1e-6)
    zipf = cases.zipf_ids()
    want, over = jax.jit(lambda t, i: j_dedup(t, i, mesh22, check_overflow=True))(sharded, zipf)
    np.testing.assert_allclose(_assemble(results, lambda r: r["lookups"]["zipf_rows"]),
                               np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(want), table[zipf], rtol=1e-6)
    assert int(over) == 0
    assert all(r["lookups"]["zipf_overflow"] == 0 for r in results)


def test_dedup_exchange_capacity_under_skew(world, mesh22):
    """All 64 uniques on model rank 0: capacity 64 is exact; at 16 JAX and
    the port count the same overflow and zero the same rows."""
    results = ranks(world)
    table, _ = cases.lookup_inputs(1000, 8, 64, 0)
    sharded = _sharded(mesh22, table)
    skew = np.arange(64, dtype=np.int32)
    for cap in (64, 16):
        want, over = jax.jit(lambda t, i: j_dedup(t, i, mesh22, capacity=cap, shard_batch=False,
                                                  check_overflow=True))(sharded, skew)
        got = _assemble(results, lambda r: r["lookups"][f"skew{cap}_rows"], sharded=False)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert all(r["lookups"][f"skew{cap}_overflow"] == int(over) for r in results)
    assert int(over) > 0


def test_dedup_exchange_replicated_batch(world, mesh22):
    table, ids = cases.lookup_inputs(1000, 8, 48, 3)
    want = np.asarray(jax.jit(lambda t, i: j_dedup(t, i, mesh22, shard_batch=False))(
        _sharded(mesh22, table), ids))
    got = _assemble(ranks(world), lambda r: r["lookups"]["replicated_rows"], sharded=False)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, table[ids], rtol=1e-6)


def test_dedup_exchange_grads(world, mesh22):
    table, ids = cases.lookup_inputs(96, 4, 16, 1)
    w = jnp.asarray(cases.grad_weights())
    g_jax = jax.jit(jax.grad(lambda t: jnp.sum(j_dedup(t, jnp.asarray(ids), mesh22) * w)))(
        _sharded(mesh22, table))
    got = _table_grad(ranks(world), "dedup_grad")
    np.testing.assert_allclose(got, np.asarray(g_jax), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _table_grad(ranks(world), "psum_grad"), rtol=1e-5, atol=1e-6)


# -- capacity helpers --------------------------------------------------------------


@pytest.mark.parametrize("n,s", [(64, 4), (8192, 8), (100, 3), (5, 8)])
def test_default_capacity_matches_the_reference(n, s):
    assert default_capacity(n, s) == j_default_capacity(n, s)


def test_capacity_from_sample_matches_the_reference():
    rs = np.random.RandomState(2)
    samples = [rs.zipf(1.2, size=64) % 1000, rs.randint(0, 1000, 256)]
    for vocab in (1000, 1003):
        for safety in (1.5, 1.0):
            assert capacity_from_sample(samples, 4, vocab, safety) == \
                j_capacity_from_sample(samples, 4, vocab, safety)


def test_auto_capacity_on_shuffled_and_ranked_vocab(world, mesh22, encodings):
    """The capacity the first batch sizes, at batch 256 on (2, 2), equals
    JAX's for the shuffled and the ranked encodings, and the shuffled one
    is under the breakeven."""
    for name, (fs, (_, cols, y)) in encodings.items():
        model = JXDeepFM(fs, {"embedding_size": 4, "cin_cross_layer_units": (4, 4),
                              "cin_dropout": (1, 1, 1), "deep_hidden_units": (8,),
                              "deep_dropout": (1.0, 1.0)})
        t = JShardedTrainer(model, hparams={"learning_rate": 0.01}, epoch=1, batch_size=256,
                            random_seed=2019, mesh=mesh22, row_shard_threshold=1000,
                            embedding_exchange="dedup")
        dev, layout = t._to_device(cols, y)
        want = t.auto_dedup_capacity(dev, np.arange(256, dtype=np.int32), layout)
        assert all(r["shuffled"][name] == want for r in ranks(world)), name
    got = ranks(world)[0]["shuffled"]
    assert got["shuffled"] * 2 / 128 < 1.0 < got["ranked"] * 2 / 128


# -- ShardedTrainer's row-sharded route ---------------------------------------------


@pytest.fixture(scope="module")
def jax_traces(world):
    return world[1]["traces"]


def _jax_traces(mesh22):
    fs = cases.schema_features(JFeatureSet, JSparseFeat, JDenseFeat)
    x, y = cases.schema_data()
    out = {}
    for exchange in ("psum", "dedup"):
        t = JShardedTrainer(JXDeepFM(fs, cases.TRAINER_HP), cases.TRAINER_OPT,
                            metrics=(JLogLoss(),), epoch=1, batch_size=cases.TRAINER_BATCH,
                            random_seed=2019,
                            mesh=mesh22, row_shard_threshold=256, embedding_exchange=exchange)
        dev, layout = t._to_device(x, y)
        idx = t._batch_index_matrix(cases.TRAINER_ROWS, shuffle_seed=1)
        losses = [float(t.fit_on_batch(dev, idx[i], layout)) for i in range(cases.TRAINER_STEPS)]
        out[exchange] = {"losses": np.asarray(losses), "capacity": t.dedup_capacity,
                         "params": {k: np.asarray(v) for k, v in t.state.params.items()},
                         "sharded": sorted(k for k, v in t.state.params.items()
                                           if v.sharding.spec != P())}
    return out


@pytest.mark.parametrize("exchange", ["psum", "dedup"])
def test_row_sharded_trainer_matches_the_reference(world, jax_traces, exchange):
    want = jax_traces[exchange]
    for r in ranks(world):
        got = r["trainers"][exchange]
        assert got["sharded"] == want["sharded"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3, atol=1e-4)
        for name, ref in want["params"].items():
            np.testing.assert_allclose(got["params"][name], ref, rtol=1e-3, atol=1e-4,
                                       err_msg=name)
    if exchange == "dedup":
        assert ranks(world)[0]["trainers"]["dedup"]["capacity"] == want["capacity"]


def test_dedup_trace_matches_psum_trace(world):
    for r in ranks(world):
        np.testing.assert_allclose(r["trainers"]["dedup"]["losses"],
                                   r["trainers"]["psum"]["losses"], rtol=1e-5, atol=1e-6)


def test_counted_bytes_match_the_traffic_model(world):
    """One step's exchange bytes over the model axis, counted by the
    collectives, equal collective_traffic_model's for the same shapes."""
    vocab, local = pad_vocab_for_mesh(cases.SCHEMA_VOCAB, 2), cases.TRAINER_BATCH // 2
    for r in ranks(world):
        tr = r["trainers"]
        kw = dict(n_tables=cases.SCHEMA_SPARSE, vocab=vocab, k=cases.TRAINER_HP["embedding_size"],
                  batch_local=local, data_shards=2, model_shards=2)
        psum = collective_traffic_model(**kw)["model_axis"]["psum_bytes"]
        assert tr["psum"]["traffic"]["all_reduce/model/table"] == psum
        assert "all_gather/model/table" not in tr["psum"]["traffic"]
        # the exchange bounds the capacity by its rows, as the reference's
        cap = min(tr["dedup"]["capacity"], local)
        dedup = collective_traffic_model(capacity=cap, **kw)["model_axis"]["dedup_bytes"]
        got = tr["dedup"]["traffic"]
        assert got["all_gather/model/table"] + got["reduce_scatter/model/table"] == dedup
        # the linear tower's psum: one all-reduce of every term's weight
        terms = cases.SCHEMA_SPARSE + cases.SCHEMA_DENSE
        for exchange in ("psum", "dedup"):
            assert tr[exchange]["traffic"]["all_reduce/model/linear"] == local * terms * 4


# -- the capacity guard at (1, 4) -----------------------------------------------------


@pytest.fixture(scope="module")
def jax_skew(world):
    return world[1]["skew"]


def _jax_skew(mesh14):
    fs = j_criteo_features(num_buckets=cases.SKEW_BUCKETS)
    data = cases.skewed_data()
    x, y = cases.split_xy(data)
    idx = np.arange(64, dtype=np.int32)

    def trainer(**kw):
        model = JXDeepFM(fs, {"embedding_size": 4, "cin_cross_layer_units": (4, 4),
                              "cin_dropout": (1, 1, 1), "deep_hidden_units": (8,),
                              "deep_dropout": (1.0, 1.0)})
        t = JShardedTrainer(model, hparams={"learning_rate": 0.01}, epoch=1, batch_size=64,
                            random_seed=2019, mesh=mesh14, row_shard_threshold=1000,
                            embedding_exchange="dedup", **kw)
        return t, *t._to_device(x, y)

    t, dev, layout = trainer()
    out = {"auto_report": t.dedup_overflow_report(dev, idx, layout)}
    t.dedup_capacity = t.auto_dedup_capacity(dev, idx, layout)
    out["auto_capacity"] = t.dedup_capacity
    t, dev, layout = trainer(dedup_capacity=64)
    out["explicit_report"] = t.dedup_overflow_report(dev, idx, layout)
    t, dev, layout = trainer(dedup_capacity=8)
    with pytest.raises(ValueError, match="dedup") as e:
        t.fit_on_batch(dev, idx, layout)
    out["undersized"] = str(e.value)
    return out


def test_skewed_ids_autosize_and_warn(world, jax_skew):
    for r in ranks(world):
        s = r["skew"]
        # at 4 model ranks the default ceil(4N/S) is N, so nothing overflows
        assert s["auto_report"] == jax_skew["auto_report"]
        assert s["auto_capacity"] == jax_skew["auto_capacity"] >= 64
        assert np.isfinite(s["auto_loss"])
        assert any("breakeven" in m for m in s["auto_warnings"])


def test_explicit_capacity_raises_or_passes(world, jax_skew):
    for r in ranks(world):
        s = r["skew"]
        assert s["undersized"] == f"ValueError: {jax_skew['undersized']}"
        assert s["explicit_report"] == jax_skew["explicit_report"]
        assert not any(s["explicit_report"].values())
        assert np.isfinite(s["explicit_loss"])


# -- data layouts -----------------------------------------------------------------------


def test_dataset_sharded_index_matrix(world, mesh22):
    fs = j_criteo_features(num_buckets=cases.LAYOUT_BUCKETS)
    model = JDeepFM(fs, {"embedding_size": 4, "deep_hidden_units": (8,),
                         "deep_dropout": (1.0, 1.0)})
    t = JShardedTrainer(model, batch_size=64, mesh=mesh22, dataset_sharded=True)
    want = t._batch_index_matrix(cases.LAYOUT_ROWS, shuffle_seed=7)
    results = ranks(world)
    for r in results:
        np.testing.assert_array_equal(r["layouts"]["index_matrix"], want)
    # every row once: block d, local i -> d * local_n + i
    idx, local_n, d_n, local_bs = want, -(-cases.LAYOUT_ROWS // 2), 2, 32
    got = [d * local_n + v for row in idx for d, part in enumerate(row.reshape(d_n, local_bs))
           for v in part if v >= 0]
    assert sorted(got) == list(range(cases.LAYOUT_ROWS))


def test_predict_row_order_matches_replicated(world):
    for r in ranks(world):
        lay = r["layouts"]
        assert lay["predict_shrd"].shape == (cases.LAYOUT_ROWS,)
        np.testing.assert_allclose(lay["predict_shrd"], lay["predict_repl"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ranks(world)[0]["layouts"]["predict_repl"],
                                  ranks(world)[3]["layouts"]["predict_repl"])


def test_multihost_feed_matches_dataset_sharded(world):
    for r in ranks(world):
        lay = r["layouts"]
        assert lay["feed_equal"] and lay["feed_index_equal"]
        np.testing.assert_allclose(*lay["feed_losses"], rtol=1e-5)
        np.testing.assert_allclose(*lay["feed_predict"], rtol=1e-5, atol=1e-6)
        assert lay["feed_needs_sharded"] == "ValueError: multihost_feed requires dataset_sharded"


# -- replicas, refusals ------------------------------------------------------------------


def test_live_dropout_keeps_replicas_equal(world):
    """Live DNN dropout on the row-sharded route: finite, not the keep-1
    losses, and the dense params bit-equal across each model group."""
    results = ranks(world)
    for r in results:
        live, keep = r["dropout"][0.5], r["dropout"][1.0]
        assert np.all(np.isfinite(live["losses"]))
        assert live["losses"] != keep["losses"]
    for d in range(2):
        group = [r["dropout"][0.5]["dense"] for r in results if r["coords"][0] == d]
        assert group[0] == group[1]


def test_tp_dropout_draws_the_replicated_masks(world):
    """Keep 0.5 with the DNN's layer column-sharded: each rank slices the
    full-width mask a replicated run draws, so the trace is the replicated
    run's (f32 sums in another order apart)."""
    for r in ranks(world):
        np.testing.assert_allclose(r["dropout"]["tp"]["losses"], r["dropout"][0.5]["losses"],
                                   rtol=1e-5)


# -- the rest of the layer against JAX's ShardedTrainer on the (2, 2) mesh ----------


def _jax_parity_setup(name):
    """(model, columns, y, rows) of a parity case in the JAX package; the
    port's encoding of the same rows is checked equal."""
    from recman_tpu.examples.din_synthetic import make_data as j_make_data
    from recman_tpu.features import SequenceFeat as JSequenceFeat
    from recman_tpu.models import MODEL_REGISTRY

    model_name, hp = cases.PARITY_CASES[name][:2]
    if model_name in ("din", "dien"):
        df = j_make_data(n=cases.SEQ_ROWS, n_items=cases.SEQ_ITEMS, max_hist=cases.SEQ_HIST)
        fs = cases.seq_features(JFeatureSet, JSparseFeat, JSequenceFeat, df)
        x, y, rows = fs.transform(df), df["label"].values.astype(np.float32), cases.SEQ_ROWS
    elif model_name == "deepfm":
        df, y = _qr_frame()
        fs = cases.qr_features(JFeatureSet, JSparseFeat, JDenseFeat, df)
        x, rows = fs.transform(df), cases.QR_ROWS
    else:
        fs = cases.schema_features(JFeatureSet, JSparseFeat, JDenseFeat)
        (x, y), rows = cases.schema_data(), cases.TRAINER_ROWS
    _, tx, ty, _ = cases.parity_setup(name, _qr_frame())
    for k, v in tx.items():
        np.testing.assert_array_equal(v, np.asarray(x[k]), err_msg=k)
    np.testing.assert_array_equal(ty, y)
    return MODEL_REGISTRY[model_name](fs, hp), x, y, rows


@pytest.fixture(scope="module")
def jax_parity(world):
    return world[1]["parity"]


def _jax_parity(mesh22):
    out = {}
    for name, (_, _, kw, opt) in cases.PARITY_CASES.items():
        model, x, y, rows = _jax_parity_setup(name)
        kw = {"row_shard_threshold": 256, "batch_size": cases.TRAINER_BATCH, **kw}
        t = JShardedTrainer(model, opt, metrics=(JLogLoss(),), epoch=1, random_seed=2019,
                            mesh=mesh22, **kw)
        # as placed: the steps' outputs take the partitioner's shardings
        specs = {k: tuple(v.sharding.spec) for k, v in t.state.params.items()}
        dev, layout = t._to_device(x, y)
        idx = t._batch_index_matrix(rows, shuffle_seed=1)
        losses = [float(t.fit_on_batch(dev, idx[i], layout)) for i in range(cases.PARITY_STEPS)]
        out[name] = {"losses": np.asarray(losses), "specs": specs,
                     "params": {k: np.asarray(v) for k, v in t.state.params.items()}}
        if name == "qr":
            d = JShardedTrainer(model, opt, epoch=1, random_seed=2019, mesh=mesh22,
                                embedding_exchange="dedup", **kw)
            with pytest.raises(KeyError, match="u_feat_embed"):
                d.dedup_overflow_report(dev, idx[0], layout)
    return out


def _held_to_jax(world, jax_parity, name):
    want = jax_parity[name]
    for r in ranks(world):
        got = r["parity"][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3, atol=1e-4)
        assert set(got["params"]) == set(want["params"])
        for k, ref in want["params"].items():
            np.testing.assert_allclose(got["params"][k], ref, rtol=1e-3, atol=1e-4, err_msg=k)
    return ranks(world)


def test_dice_moments_over_the_data_group(world, jax_parity):
    """DIN (Dice in the attention and the DNN) at (2, 2): the reference's
    partitioner takes Dice's moments over the global batch, so every data
    rank's must be the data group's."""
    results = _held_to_jax(world, jax_parity, "din")
    assert results[0]["parity"]["din"]["specs"]["item_id_feat_embed"] == ("model", None)


def test_tp_dnn_matches_the_reference(world, jax_parity):
    """xDeepFM's (64, 64, 33) DNN at tp_dense_threshold 1000: layer 0
    column-sharded, layer 1 row-sharded, layer 2's 33 columns replicated
    (the fallback), as JAX places them; traces and params as JAX's."""
    results = _held_to_jax(world, jax_parity, "xdeepfm_tp")
    want = jax_parity["xdeepfm_tp"]["specs"]
    for r in results:
        got = r["parity"]["xdeepfm_tp"]
        assert got["specs"] == want
        assert got["specs"]["dnn_layer_0_weights"] == (None, "model")
        assert got["specs"]["dnn_layer_1_weights"] == ("model", None)
        assert got["specs"]["dnn_layer_2_weights"] == ()
        assert got["blocks"]["dnn_layer_0_weights"] == (18, 32)
        assert got["blocks"]["dnn_layer_1_weights"] == (32, 64)


def test_tp_dnn_with_dice_matches_the_reference(world, jax_parity):
    """DIN's Dice DNN tensor-parallel: its column layer's bias, Dice alpha
    and moments are replicated leaves each rank reads a block of."""
    results = _held_to_jax(world, jax_parity, "din_tp")
    got = results[0]["parity"]["din_tp"]
    assert got["specs"]["dnn_layer_0_weights"] == (None, "model")
    assert got["specs"]["dnn_dice_alpha_0"] == got["specs"]["dnn_layer_0_bias"] == ()


def test_dien_aux_loss_matches_the_reference(world, jax_parity):
    """DIEN with aux_loss_weight 0.5 at (2, 2): the per-rank split of its
    loss, its in-batch negatives rolled across the data ranks."""
    _held_to_jax(world, jax_parity, "dien_aux")


def test_qr_quotient_table_row_shards(world, jax_parity):
    """tests/test_qr_embedding.py's sharded case at (2, 2): the quotient
    table row-shards and the trace is JAX's. Under dedup the port's guard
    counts the quotient lookups (ids // q over ceil(V/q) rows); the
    reference's raises KeyError there (jax_parity), a fault logged in
    ROADMAP.md."""
    results = _held_to_jax(world, jax_parity, "qr")
    for r in results:
        got = r["parity"]["qr"]
        assert got["specs"]["u_feat_embed_q"] == ("model", None)
        assert got["dedup_report"] == {"u(quotient)": 0, "u(bias)": 0}


def test_lamb_over_blocks_matches_the_reference(world, jax_parity):
    """optimizer="lamb" with row-sharded tables and a tensor-parallel DNN:
    each blocked leaf's trust ratio takes the whole leaf's norms."""
    results = _held_to_jax(world, jax_parity, "xdeepfm_lamb")
    got = results[0]["parity"]["xdeepfm_lamb"]["specs"]
    assert got["C0_feat_embed"] == ("model", None) and got["dnn_layer_1_weights"] == ("model", None)


# -- the zoo and the sequence models at (2, 2), against the plain Trainer ------------


@pytest.fixture(scope="module")
def plain_zoo():
    from recman_tpu_torch.training import LogLoss, Trainer, init_state

    out = {}
    for name in cases.ZOO_MODELS + cases.SEQ_MODELS:
        model, x, y, rows = cases.zoo_setup(name)
        t = Trainer(model, cases.ZOO_OPT, metrics=(LogLoss(),), epoch=1,
                    batch_size=cases.TRAINER_BATCH, random_seed=2019, device="cpu")
        t.state = init_state(model, t.optimizer, cases.JaxKey(2019), device="cpu")
        run = cases.zoo_run(t, x, y, rows)
        run["params"] = {k: v.numpy() for k, v in t.state.params.items()}
        out[name] = run
    return out


@pytest.mark.parametrize("name", cases.ZOO_MODELS + cases.SEQ_MODELS)
def test_model_learns_on_the_mesh(world, plain_zoo, name):
    """tests/test_parallel.py's TestRound2ZooSharded and
    TestSequenceModelsSharded at (2, 2), tables row-sharded at 256: the
    model learns, its trace and params track the plain Trainer's on the
    same rows, and calibrate writes the plain Trainer's moments on every
    rank (Dice on row-sharded tables)."""
    want = plain_zoo[name]
    for r in ranks(world):
        got = r["zoo"][name]
        assert got["sharded"], name
        assert got["after"] < got["before"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["after"], want["after"], rtol=1e-3, atol=1e-4)
        assert got["calibrated"] == want["calibrated"]
        for k, ref in want["params"].items():
            np.testing.assert_allclose(got["params"][k][:ref.shape[0]], ref, rtol=1e-3, atol=1e-4,
                                       err_msg=k)


# -- checkpoints, preemption, streams ---------------------------------------------------


def test_sharded_checkpoint_holds_global_arrays(world):
    results = ranks(world)
    for r in results:
        ck = r["checkpoints"]
        assert ck["files"] == ["feat_dict.json", "hparams.json", "state"]
        assert ck["restored_equal"]
    shapes = results[0]["checkpoints"]["saved_shapes"]
    assert shapes["C0_feat_embed"] == (pad_vocab_for_mesh(cases.SCHEMA_VOCAB, 2), 4)
    assert shapes["dnn_layer_0_weights"] == (18, 64) and shapes["dnn_layer_1_weights"] == (64, 64)
    opt = results[0]["checkpoints"]["saved_opt"]
    assert opt["mu/C0_feat_embed"] == shapes["C0_feat_embed"]
    assert opt["nu/dnn_layer_0_weights"] == (18, 64)


@pytest.mark.parametrize("run", ["fit", "stream"])
def test_preempted_by_one_rank_resumes_bit_exact(world, run):
    """Rank 1's flag alone set before step 7: every rank checkpoints at
    step 7 and raises Preempted; fresh trainers resume from LATEST.json
    to every param, optimizer-state tensor, the step and the generator of
    an uninterrupted run (torch.equal, by digest), at (2, 2)."""
    for r in ranks(world):
        got = r["checkpoints"][run]
        assert got["preempted"] is not None and f"step {cases.PREEMPT_STEP}" in got["preempted"]
        assert got["saved_step"] == cases.PREEMPT_STEP
        assert got["latest"]["step"] == cases.PREEMPT_STEP
        if run == "stream":
            assert got["latest"]["stream"] == {"epoch": 2, "chunk": 0, "batch": 1}
        assert got["resumed"] == got["ref"]


@pytest.fixture(scope="module")
def plain_stream():
    from recman_tpu_torch.training import Trainer, init_state

    model, _ = cases.trainer_setup(cases.RESUME_HP)
    x, y = cases.schema_data(cases.RESUME_ROWS)
    t = Trainer(model, cases.TRAINER_OPT, epoch=1, batch_size=cases.TRAINER_BATCH,
                random_seed=2019, device="cpu")
    t.state = init_state(model, t.optimizer, cases.JaxKey(2019), device="cpu")
    t.fit_stream(cases.stream_chunks(x, y), epochs=1)
    return {k: v.numpy() for k, v in t.state.params.items()}


def test_fit_stream_matches_the_plain_trainer(world, plain_stream):
    for r in ranks(world):
        got = r["streams"]
        for k, ref in plain_stream.items():
            np.testing.assert_allclose(got["params"][k][:ref.shape[0]], ref, rtol=1e-3, atol=1e-4,
                                       err_msg=k)
        np.testing.assert_array_equal(got["predict_stream"], got["predict"])
        assert got["predict"].shape == (cases.RESUME_ROWS,)
        assert np.isfinite(got["evaluate_stream"]).all()


def test_unequal_chunks_raise_on_every_rank(world):
    for r in ranks(world):
        assert r["streams"]["unequal"] == (
            "ValueError: the ranks' chunks have unequal batch counts [5, 5, 7, 7] (in mesh rank "
            "order; 0: the stream ended): every rank must be fed chunks of as many rows")


def test_no_refusal_is_left():
    """Every item that the parallel layer refused until it was ported takes
    its parity case below; no "not ported" refusal is left."""
    from pathlib import Path

    import recman_tpu_torch.parallel as par

    for path in Path(par.__file__).parent.glob("*.py"):
        assert "ROADMAP.md queue 1" not in path.read_text(), path.name
    model, _ = cases.trainer_setup()
    t = ShardedTrainer(model, tp_dense_threshold=1000, row_shard_threshold=256, device="cpu")
    assert t.specs["dnn_layer_0_weights"] == ()  # one rank: dims divide 1, the blocks are whole
    import torch.distributed as dist

    dist.destroy_process_group()


def test_resilience_on_a_mesh(tmp_path):
    """``ShardedTrainer`` runs a plain Resilience as a MeshResilience of its
    settings, a MeshResilience as it is, and refuses another subclass of
    Resilience, whose overrides would not run through the agreement."""
    from recman_tpu_torch.parallel import MeshResilience
    from recman_tpu_torch.parallel.checkpoint import on_mesh
    from recman_tpu_torch.training import Resilience

    plain = Resilience(tmp_path, every_steps=3, every_epochs=2, keep=4, preempt_signals=(),
                       halt_on_nonfinite=False)
    got = on_mesh(plain)
    assert type(got) is MeshResilience
    assert {k: getattr(got, k) for k in vars(plain)} == vars(plain)
    mesh_res = MeshResilience(tmp_path)
    assert on_mesh(mesh_res) is mesh_res and on_mesh(None) is None

    class Own(Resilience):
        pass

    with pytest.raises(TypeError, match="subclass of parallel.MeshResilience"):
        on_mesh(Own(tmp_path))


def test_world_cases_import_no_jax():
    """Every rank imports tests/torch_parallel_cases.py: it must import no
    JAX (the port's own modules are checked by tests/test_torch_xdeepfm.py)."""
    import ast
    from pathlib import Path

    tree = ast.parse(Path(cases.__file__).read_text())
    for node in ast.walk(tree):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
            [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
        assert not any(n.split(".")[0] in ("jax", "recman_tpu") for n in names), names


class _FakeMesh:
    """A rank's place in a mesh, without a process group (placement needs
    no collective)."""

    def __init__(self, data, model, coords):
        self.shape, self.coords = {"data": data, "model": model}, coords


def test_lamb_over_row_blocks_takes_the_whole_leafs_norms():
    """Lamb on two row blocks of a leaf, each block's norms summed with the
    other's (as the model group's all-reduce sums them), updates each block
    as Lamb on the whole leaf does; a replicated leaf keeps its own norm.
    shard_state takes lamb over blocks."""
    from recman_tpu_torch.parallel.train_pjit import shard_state
    from recman_tpu_torch.training import create_optimizer
    from recman_tpu_torch.training.train_step import Lamb
    from recman_tpu_torch.utils.sharded_run import sharded_run

    class Run:
        """A sharded run's face to Lamb: one blocked leaf, and the model
        group's sum of its squared norms."""

        def __init__(self, reduce):
            self.sum_over_blocks = reduce

        def blocked(self, name):
            return name == "big_feat_embed"

    rs = np.random.RandomState(0)
    full = {"big_feat_embed": torch.tensor(rs.randn(6, 2), dtype=torch.float32),
            "w": torch.tensor(rs.randn(3), dtype=torch.float32)}
    grads = {k: torch.tensor(rs.randn(*v.shape), dtype=torch.float32) for k, v in full.items()}
    lamb = Lamb(0.1, weight_decay=0.01)
    want, _ = lamb.update(grads, lamb.init(full), full)
    blocks = [{"big_feat_embed": full["big_feat_embed"][3 * m:3 * (m + 1)], "w": full["w"]}
              for m in range(2)]
    gblocks = [{"big_feat_embed": grads["big_feat_embed"][3 * m:3 * (m + 1)], "w": grads["w"]}
               for m in range(2)]
    sq = []
    for b, g in zip(blocks, gblocks):  # each block's (||p||^2, ||u||^2) alone
        seen = {}
        with sharded_run(Run(lambda t: seen.setdefault("sq", t))):
            lamb.update(g, lamb.init(b), b)
        sq.append(seen["sq"])
    for m, (b, g) in enumerate(zip(blocks, gblocks)):
        with sharded_run(Run(lambda t: sq[0] + sq[1])):
            got, _ = lamb.update(g, lamb.init(b), b)
        np.testing.assert_allclose(got["big_feat_embed"].numpy(),
                                   want["big_feat_embed"][3 * m:3 * (m + 1)].numpy(), rtol=1e-6)
        assert torch.equal(got["w"], want["w"])
    params = {"big_feat_embed": np.ones((6, 2), np.float32), "w": np.ones(3, np.float32)}
    specs = param_specs(params, row_shard_threshold=4)
    state = shard_state(create_optimizer("lamb", 0.1), params, _FakeMesh(1, 2, (0, 1)), specs, 0,
                        "cpu")
    assert torch.equal(state.params["big_feat_embed"], torch.ones(3, 2))
    assert state.opt_state.mu["big_feat_embed"].shape == (3, 2)


def test_psum_gathers_take_the_lookups_backward(monkeypatch):
    """With the fused backward on (the CUDA route, forced here on the CPU),
    the psum exchange's local gathers take the lookups' backwards (K3's
    twin for the same-shape blocks, K6's under "segmat" for the rest):
    rows and gradients as autograd's gather gives them, no index_add_."""
    from recman_tpu_torch.ops import embedding as emb
    from recman_tpu_torch.parallel.shard_lookup import _psum_rows

    class OneRank:
        shape, model_index = {"data": 1, "model": 1}, 0

    rs = np.random.RandomState(5)
    tables = [torch.tensor(rs.randn(50, 8), dtype=torch.float32) for _ in range(3)]
    tables.append(torch.tensor(rs.randn(40, 1), dtype=torch.float32))
    ids = [torch.tensor(rs.randint(0, t.shape[0], 64)) for t in tables]
    ws = [torch.tensor(rs.randn(64, t.shape[1]), dtype=torch.float32) for t in tables]
    out = {}
    for route in ("autograd", "lookups"):
        if route == "lookups":
            monkeypatch.setattr(emb, "_scatter_sorted_rows", None)  # no index_add_ route
        leaves = [t.clone().requires_grad_(True) for t in tables]
        fused = emb.fused_grad(route == "lookups")
        with fused, emb.grad_kernel("segmat"):
            rows = _psum_rows(leaves, ids, OneRank())
            sum((r * w).sum() for r, w in zip(rows, ws)).backward()
        out[route] = ([r.detach() for r in rows], [t.grad for t in leaves])
    for a, b in zip(out["autograd"][0] + out["autograd"][1], out["lookups"][0] + out["lookups"][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-7)


def test_torch_tensor_blocks_stay_tensors():
    params = {"big_feat_embed": torch.arange(10.0).reshape(5, 2)}
    from recman_tpu_torch.parallel import place_params

    placed = place_params(params, _FakeMesh(1, 1, (0, 0)), row_shard_threshold=2)
    assert isinstance(placed["big_feat_embed"], torch.Tensor)
    assert torch.equal(placed["big_feat_embed"], params["big_feat_embed"])
