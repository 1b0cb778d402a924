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


@pytest.fixture(scope="module")
def world(encodings):
    """The port's side, started once; each test waits for it."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(run_world, cases.parallel_world, 4,
                             args=({k: v[1] for k, v in encodings.items()},),
                             timeout_s=WORLD_TIMEOUT_S)
        yield future


def ranks(world):
    results = world.result()
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


def test_param_specs_match_the_reference():
    params = {"C1_feat_embed": np.zeros((100_000, 8), np.float32),
              "small_feat_embed": np.zeros((50, 8), np.float32),
              "linear_w": np.zeros((2_600_000, 1), np.float32),
              "C2_feat_embed_q": np.zeros((60_000, 8), np.float32),
              "C3_feat_bias": np.zeros((70_000,), np.float32),
              "dnn_layer_0_weights": np.zeros((400, 400), np.float32)}
    want = j_param_specs({k: jnp.asarray(v) for k, v in params.items()}, 50_000)
    got = param_specs(params, 50_000)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["C1_feat_embed"] == ("model", None) and got["dnn_layer_0_weights"] == ()
    assert pad_vocab_for_mesh(100, 8) == 104 and pad_vocab_for_mesh(96, 8) == 96


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
def jax_traces(mesh22):
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
def jax_skew(mesh14):
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


def test_not_ported_yet_refusals(world):
    for r in ranks(world):
        ref = r["refusals"]
        for what in ("resilience", "save", "restore", "fit_stream", "predict_stream",
                     "evaluate_stream"):
            assert ref[what].startswith("NotImplementedError") and "ROADMAP.md queue 1" in ref[what]


def test_tp_and_own_loss_models_refused():
    from recman_tpu_torch.models import DIEN
    from recman_tpu_torch.features import FeatureSet, SequenceFeat, SparseFeat
    from recman_tpu_torch.examples.din_synthetic import make_data

    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        param_specs({"dnn_layer_0_weights": np.zeros((4, 4))}, tp_dense_threshold=10)
    model, _ = cases.trainer_setup()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        ShardedTrainer(model, tp_dense_threshold=1000, device="cpu")
    data = make_data(n=64)
    fs = FeatureSet()
    item = SparseFeat("item_id", feat_size=len(np.unique(data["item_id"])))
    fs["item_id"] = item
    fs["hist_items"] = SequenceFeat("hist_items", id_feat=item, max_len=8)
    fs.initialize(data)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        ShardedTrainer(DIEN(fs), device="cpu")


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


def test_lamb_over_row_blocks_is_refused():
    """lamb's trust ratio needs each leaf's norm, across its blocks."""
    from recman_tpu_torch.parallel.train_pjit import shard_state
    from recman_tpu_torch.training import create_optimizer

    params = {"big_feat_embed": np.ones((6, 2), np.float32), "w": np.ones(3, np.float32)}
    specs = param_specs(params, row_shard_threshold=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        shard_state(create_optimizer("lamb", 0.1), params, _FakeMesh(1, 2, (0, 1)), specs, 0, "cpu")
    state = shard_state(create_optimizer("adam", 0.1), params, _FakeMesh(1, 2, (0, 1)), specs, 0,
                        "cpu")
    assert torch.equal(state.params["big_feat_embed"], torch.ones(3, 2))


def test_torch_tensor_blocks_stay_tensors():
    params = {"big_feat_embed": torch.arange(10.0).reshape(5, 2)}
    from recman_tpu_torch.parallel import place_params

    placed = place_params(params, _FakeMesh(1, 1, (0, 0)), row_shard_threshold=2)
    assert isinstance(placed["big_feat_embed"], torch.Tensor)
    assert torch.equal(placed["big_feat_embed"], params["big_feat_embed"])
