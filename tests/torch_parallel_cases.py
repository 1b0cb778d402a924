"""The ranks' side of tests/test_torch_parallel.py and
tests/test_torch_explicit_dp.py: one function per world, run on every
rank by ``recman_tpu_torch.parallel.launch.run_world``. It imports torch
and the port only (every rank imports this module), builds the same
inputs from the same seeds as the JAX side of the tests, runs every case
of its file and returns numpy results; the tests hold them against the
JAX package."""

from __future__ import annotations

import hashlib
import logging

import numpy as np
import torch

from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.parallel import (
    ShardedTrainer,
    dedup_embedding_lookup,
    make_mesh,
    pad_vocab_for_mesh,
    param_specs,
    place_params,
    shard_init_state,
    sharded_embedding_lookup,
)
from recman_tpu_torch.parallel import collectives
from recman_tpu_torch.parallel.sharding import gather_params
from recman_tpu_torch.training import LogLoss
from recman_tpu_torch.utils import JaxKey

# -- shared setups (the JAX side builds the same from the same seeds) -------

# ShardedTrainer's cases: 4 hashed fields of 601 rows and 2 dense ones, so
# the JAX side's steps stay short; adagrad (its update is linear in the
# gradient, so f32 sums in another order stay that small in the params)
SCHEMA_SPARSE, SCHEMA_DENSE, SCHEMA_VOCAB = 4, 2, 601
TRAINER_HP = {"embedding_size": 4, "cin_cross_layer_units": (4, 4), "cin_dropout": (1, 1, 1),
              "deep_hidden_units": (8,), "deep_dropout": (1.0, 1.0),
              "embedding_l2_reg": 1e-3, "linear_l2_reg": 1e-3}
TRAINER_OPT = {"learning_rate": 0.1, "optimizer": "adagrad"}
TRAINER_ROWS, TRAINER_BATCH, TRAINER_STEPS = 512, 64, 6
SKEW_BUCKETS, SKEW_ROWS = 2048, 128
LAYOUT_BUCKETS, LAYOUT_ROWS = 500, 301
FEED_ROWS = 300

DP_HP = {"embedding_size": 8, "cin_cross_layer_units": (8, 6), "cin_dropout": (1, 1, 1),
         "deep_hidden_units": (16, 16), "deep_dropout": (1.0, 1.0, 1.0)}
DP_BUCKETS, DP_ROWS, DP_BATCH, DP_STEPS = 4096, 512, 64, 6
AUTO_BUCKETS, AUTO_ROWS = 512, 256


def lookup_inputs(v, k, n, seed, model_n=2, lo=0, hi=None):
    """TestDedupLookup._setup's arrays: the padded table and the ids."""
    rs = np.random.RandomState(seed)
    vp = pad_vocab_for_mesh(v, model_n)
    table = rs.randn(vp, k).astype(np.float32)
    ids = rs.randint(lo, hi or v, n).astype(np.int32)
    return table, ids


def zipf_ids():
    return np.minimum(np.random.RandomState(7).zipf(1.5, 128) - 1, 999).astype(np.int32)


def grad_weights(n=16, k=4):
    return np.random.RandomState(2).randn(n, k).astype(np.float32)


def placement_params():
    rs = np.random.RandomState(4)
    return {"C1_feat_embed": rs.randn(1001, 8).astype(np.float32),
            "small_feat_embed": rs.randn(50, 8).astype(np.float32),
            "linear_w": rs.randn(2603).astype(np.float32),
            "dnn_layer_0_weights": rs.randn(16, 16).astype(np.float32)}


def schema_features(feature_set, sparse, dense):
    """The trainer cases' schema, from either package's feature classes."""
    fs = feature_set()
    for c in range(SCHEMA_SPARSE):
        fs[f"C{c}"] = sparse(f"C{c}", feat_size=SCHEMA_VOCAB)
    for c in range(SCHEMA_DENSE):
        fs[f"I{c}"] = dense(f"I{c}")
    return fs


def schema_data(rows=TRAINER_ROWS, seed=3):
    """(columns, y) of the trainer cases' schema."""
    rs = np.random.RandomState(seed)
    x = {f"C{c}": rs.randint(0, SCHEMA_VOCAB, rows).astype(np.int32) for c in range(SCHEMA_SPARSE)}
    x.update({f"I{c}": rs.rand(rows).astype(np.float32) for c in range(SCHEMA_DENSE)})
    return x, rs.randint(0, 2, rows).astype(np.float32)


def trainer_setup(hp=TRAINER_HP):
    from recman_tpu_torch.features import DenseFeat, FeatureSet, SparseFeat

    return XDeepFM(schema_features(FeatureSet, SparseFeat, DenseFeat), hp), schema_data()


def skewed_data():
    """All categorical ids in model rank 0's rows: more uniques than the
    default capacity ceil(4N/S) allows."""
    data = synthetic_criteo_arrays(SKEW_ROWS, num_buckets=SKEW_BUCKETS, seed=3)
    for name in list(data):
        if name.startswith("C"):
            data[name] = np.arange(1, SKEW_ROWS + 1, dtype=np.int32)
    return data


def split_xy(data):
    return {k: v for k, v in data.items() if k != "y"}, data["y"]


# -- helpers on a rank ---------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _digest(params: dict, names) -> dict:
    return {k: hashlib.sha256(_np(params[k]).tobytes()).hexdigest() for k in names}


def _raises(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:  # the cases' expected refusals
        return f"{type(e).__name__}: {e}"
    return None


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _trainer(model, mesh, **kw):
    kw = {"hparams": TRAINER_OPT, "metrics": (LogLoss(),), "epoch": 1, "batch_size": TRAINER_BATCH,
          "random_seed": 2019, "device": "cpu", **kw}
    t = ShardedTrainer(model, mesh=mesh, **kw)
    # the reference's params: JAX's ShardedTrainer draws them from PRNGKey(seed)
    t.state = shard_init_state(model, t.optimizer, JaxKey(kw["random_seed"]), mesh,
                               t.row_shard_threshold, device="cpu")
    return t


def _lookups(mesh):
    """The psum and dedup exchanges at (2, 2): rows, overflow counts and the
    table gradients summed over the data group, per case."""
    d, m = mesh.coords
    out = {}

    def block(table):
        rows = table.shape[0] // mesh.shape["model"]
        return torch.tensor(table[m * rows:(m + 1) * rows])

    def mine(ids, sharded=True):
        ids = torch.tensor(ids)
        if not sharded:
            return ids
        n = ids.shape[0] // mesh.shape["data"]
        return ids[d * n:(d + 1) * n]

    table, ids = lookup_inputs(1000, 8, 64, 0)
    out["psum_rows"] = _np(sharded_embedding_lookup(block(table), mine(ids), mesh))
    out["dedup_rows"] = _np(dedup_embedding_lookup(block(table), mine(ids), mesh))
    rows, over = dedup_embedding_lookup(block(table), mine(zipf_ids()), mesh, check_overflow=True)
    out["zipf_rows"], out["zipf_overflow"] = _np(rows), int(over)
    skew = np.arange(64, dtype=np.int32)
    for cap in (64, 16):
        rows, over = dedup_embedding_lookup(block(table), mine(skew, False), mesh, capacity=cap,
                                            shard_batch=False, check_overflow=True)
        out[f"skew{cap}_rows"], out[f"skew{cap}_overflow"] = _np(rows), int(over)
    table3, ids3 = lookup_inputs(1000, 8, 48, 3)
    out["replicated_rows"] = _np(dedup_embedding_lookup(block(table3), mine(ids3, False), mesh,
                                                        shard_batch=False))
    table1, ids1 = lookup_inputs(96, 4, 16, 1)
    w = torch.tensor(grad_weights())
    for name, fn in (("psum", lambda t, i: sharded_embedding_lookup(t, i, mesh)),
                     ("dedup", lambda t, i: dedup_embedding_lookup(t, i, mesh))):
        leaf = block(table1).requires_grad_(True)
        (fn(leaf, mine(ids1)) * mine(w.numpy())).sum().backward()
        g = collectives.all_reduce(leaf.grad, mesh, "data")
        out[f"{name}_grad"] = _np(g)
    return out


def _placement(mesh):
    params = placement_params()
    specs = param_specs(params, row_shard_threshold=256)
    return {"specs": specs, "blocks": place_params(params, mesh, specs)}


def _row_sharded_trainers(mesh):
    """XDeepFM at (2, 2), threshold 256: a 6-step trace per exchange, the
    gathered params, one step's counted bytes, the dedup capacity."""
    out = {}
    model, (x, y) = trainer_setup()
    for exchange in ("psum", "dedup"):
        t = _trainer(model, mesh, row_shard_threshold=256, embedding_exchange=exchange)
        dev, layout = t._to_device(x, y)
        idx = t._batch_index_matrix(TRAINER_ROWS, shuffle_seed=1)
        losses, traffic = [], None
        for i in range(TRAINER_STEPS):
            collectives.reset_traffic()
            losses.append(float(t.fit_on_batch(dev, idx[i], layout)))
            if i == 1:  # a step after the first batch's capacity guard
                traffic = {f"{op}/{axis}/{tag}": b for (op, axis, tag), b in
                           collectives.TRAFFIC.items()}
        full = gather_params(t.state.params, mesh, t.specs)
        out[exchange] = {"losses": losses, "traffic": traffic, "capacity": t.dedup_capacity,
                         "sharded": sorted(k for k, s in t.specs.items() if s),
                         "params": {k: _np(v) for k, v in full.items()}}
    return out


def _skew_cases(mesh14):
    """TestDedupOverflowGuard at (1, 4): auto-size and warning, an undersized
    explicit capacity refused, an explicit capacity that passes."""
    out = {}
    fs = create_criteo_features(num_buckets=SKEW_BUCKETS)
    model = XDeepFM(fs, {"embedding_size": 4, "cin_cross_layer_units": (4, 4),
                         "cin_dropout": (1, 1, 1), "deep_hidden_units": (8,),
                         "deep_dropout": (1.0, 1.0)})
    x, y = split_xy(skewed_data())
    idx = np.arange(64, dtype=np.int32)
    kw = {"hparams": {"learning_rate": 0.01}, "row_shard_threshold": 1000,
          "embedding_exchange": "dedup"}

    t = _trainer(model, mesh14, **kw)
    dev, layout = t._to_device(x, y)
    out["auto_report"] = t.dedup_overflow_report(dev, idx, layout)
    records = _Records()
    logging.getLogger("recman_tpu_torch.parallel.train_pjit").addHandler(records)
    try:
        out["auto_loss"] = float(t.fit_on_batch(dev, idx, layout))
    finally:
        logging.getLogger("recman_tpu_torch.parallel.train_pjit").removeHandler(records)
    out["auto_capacity"] = t.dedup_capacity
    out["auto_warnings"] = records.messages

    t = _trainer(model, mesh14, dedup_capacity=8, **kw)
    dev, layout = t._to_device(x, y)
    out["undersized"] = _raises(lambda: t.fit_on_batch(dev, idx, layout))

    t = _trainer(model, mesh14, dedup_capacity=64, **kw)
    dev, layout = t._to_device(x, y)
    out["explicit_report"] = t.dedup_overflow_report(dev, idx, layout)
    out["explicit_loss"] = float(t.fit_on_batch(dev, idx, layout))
    return out


def _shuffled_capacity(mesh, encoded):
    """TestAutoCapacityShuffledVocab's capacities at (2, 2), batch 256, for
    the shuffled and the ranked encodings (``encoded``: name -> (feature
    sizes, columns, y))."""
    from recman_tpu_torch.features import FeatureSet, SparseFeat

    out = {}
    for name, (sizes, cols, y) in encoded.items():
        fs = FeatureSet()
        for c, size in sizes.items():
            fs[c] = SparseFeat(c, feat_size=size)
        model = XDeepFM(fs, {"embedding_size": 4, "cin_cross_layer_units": (4, 4),
                             "cin_dropout": (1, 1, 1), "deep_hidden_units": (8,),
                             "deep_dropout": (1.0, 1.0)})
        t = _trainer(model, mesh, batch_size=256, row_shard_threshold=1000,
                     embedding_exchange="dedup", hparams={"learning_rate": 0.01})
        dev, layout = t._to_device(cols, y)
        out[name] = t.auto_dedup_capacity(dev, np.arange(256, dtype=np.int32), layout)
    return out


def _layouts(mesh):
    """TestShardedDataset at (2, 2): the local index matrix, predictions in
    row order, and multihost_feed against dataset_sharded."""
    out = {}
    from recman_tpu_torch.models import DeepFM

    fs = create_criteo_features(num_buckets=LAYOUT_BUCKETS)
    model = DeepFM(fs, {"embedding_size": 4, "deep_hidden_units": (8,),
                        "deep_dropout": (1.0, 1.0)})
    x, y = split_xy(synthetic_criteo_arrays(LAYOUT_ROWS, num_buckets=LAYOUT_BUCKETS, seed=5))
    repl = _trainer(model, mesh)
    shrd = _trainer(model, mesh, dataset_sharded=True)
    out["index_matrix"] = shrd._batch_index_matrix(LAYOUT_ROWS, shuffle_seed=7)
    out["predict_repl"], out["predict_shrd"] = repl.predict(x), shrd.predict(x)

    x, y = split_xy(synthetic_criteo_arrays(FEED_ROWS, num_buckets=LAYOUT_BUCKETS, seed=5))
    half = FEED_ROWS // mesh.shape["data"]
    d = mesh.data_index
    xb, yb = {k: v[d * half:(d + 1) * half] for k, v in x.items()}, y[d * half:(d + 1) * half]
    base = _trainer(model, mesh, dataset_sharded=True)
    multi = _trainer(model, mesh, dataset_sharded=True, multihost_feed=True)
    dev_b, _ = base._to_device(x, y)
    dev_m, _ = multi._to_device(xb, yb)
    out["feed_equal"] = all(torch.equal(dev_b[k], dev_m[k]) for k in dev_b)
    out["feed_index_equal"] = np.array_equal(base._batch_index_matrix(FEED_ROWS, 2019),
                                             multi._batch_index_matrix(half, 2019))
    base.fit(x, y, random_seed_for_mini_batch=False)
    multi.fit(xb, yb, random_seed_for_mini_batch=False)
    out["feed_losses"] = (base.last_mean_loss, multi.last_mean_loss)
    out["feed_predict"] = (base.predict(x)[d * half:(d + 1) * half], multi.predict(xb))
    out["feed_needs_sharded"] = _raises(lambda: ShardedTrainer(
        model, mesh=mesh, batch_size=64, multihost_feed=True, device="cpu"))
    return out


def _dropout(mesh):
    """Live DNN dropout on the row-sharded route at (2, 2): the losses and
    the dense params' digests after 2 steps, and the keep-1 run's losses."""
    out = {}
    for keep in (1.0, 0.5):
        hp = dict(TRAINER_HP, deep_dropout=(keep, keep))
        model, (x, y) = trainer_setup(hp=hp)
        t = _trainer(model, mesh, row_shard_threshold=256)
        dev, layout = t._to_device(x, y)
        idx = t._batch_index_matrix(TRAINER_ROWS, shuffle_seed=1)
        losses = [float(t.fit_on_batch(dev, idx[i], layout)) for i in range(2)]
        dense = [k for k, s in t.specs.items() if not s]
        out[keep] = {"losses": losses, "dense": _digest(t.state.params, dense)}
    return out


def _refusals(mesh):
    model, (x, y) = trainer_setup()
    t = _trainer(model, mesh, row_shard_threshold=256)
    return {
        "resilience": _raises(lambda: t.fit(x, y, resilience=object())),
        "save": _raises(lambda: t.save("unused")),
        "restore": _raises(lambda: t.restore("unused")),
        "fit_stream": _raises(lambda: t.fit_stream(lambda: iter(()))),
        "predict_stream": _raises(lambda: t.predict_stream(iter(()))),
        "evaluate_stream": _raises(lambda: t.evaluate_stream(iter(()))),
        "mesh_factorization": _raises(lambda: make_mesh(data=3, model=3)),
        "model_factorization": _raises(lambda: make_mesh(model=3)),
    }


def parallel_world(encoded):
    """Every case of tests/test_torch_parallel.py on a world of 4 ranks."""
    mesh = make_mesh(data=2, model=2)
    mesh14 = make_mesh(data=1, model=4)
    return {
        "coords": mesh.coords,
        "placement": _placement(mesh),
        "lookups": _lookups(mesh),
        "trainers": _row_sharded_trainers(mesh),
        "skew": _skew_cases(mesh14),
        "shuffled": _shuffled_capacity(mesh, encoded),
        "layouts": _layouts(mesh),
        "dropout": _dropout(mesh),
        "refusals": _refusals(mesh),
    }


# -- explicit DP (tests/test_torch_explicit_dp.py) ----------------------------


def dp_setup(hp=DP_HP):
    from recman_tpu_torch.training import pack_dataset
    from recman_tpu_torch.training.trainer import batch_indices

    fs = create_criteo_features(num_buckets=DP_BUCKETS)
    data, layout = pack_dataset(synthetic_criteo_arrays(DP_ROWS, num_buckets=DP_BUCKETS, seed=5))
    idx_mat = batch_indices(DP_ROWS, DP_BATCH, shuffle_seed=0)
    idx_mat = idx_mat[(idx_mat >= 0).all(axis=1)][:DP_STEPS]
    return XDeepFM(fs, hp), {k: torch.as_tensor(v) for k, v in data.items()}, layout, idx_mat


def dp_run(model, mesh, opt, steps, stacked=False, data=None, layout=None, idx_mat=None):
    """``steps`` explicit DP steps from JaxKey(0)'s params: (losses, the
    per-table params)."""
    from recman_tpu_torch.parallel.train_explicit import make_dp_train_step_explicit
    from recman_tpu_torch.training import (
        init_state,
        stack_train_state,
        unstack_table_params,
    )

    state = init_state(model, opt, JaxKey(0), device="cpu")
    names = None
    if stacked:
        state = stack_train_state(model, state)
        names = model.packed.stackable()
    step = make_dp_train_step_explicit(model, opt, mesh, unroll=steps, stacked_names=names)
    state, losses = step(state, data, torch.as_tensor(idx_mat[:steps]), layout)
    return _np(losses), {k: _np(v) for k, v in unstack_table_params(model, state.params).items()}


def explicit_dp_world():
    """Every world case of tests/test_torch_explicit_dp.py on 2 ranks."""
    from recman_tpu_torch.parallel.train_explicit import (
        explicit_dp_supported,
        make_dp_eval_scan_explicit,
    )
    from recman_tpu_torch.training import (
        create_optimizer,
        init_state,
        make_train_step_stacked,
        make_train_step_unrolled,
        stack_train_state,
    )

    mesh = make_mesh(data=2, model=1)
    mesh12 = make_mesh(data=1, model=2)
    model, data, layout, idx_mat = dp_setup()
    adam = create_optimizer("adam", 1e-3)
    run = dict(data=data, layout=layout, idx_mat=idx_mat)
    out = {"rank": mesh.data_index}
    out["trajectory"] = dp_run(model, mesh, adam, DP_STEPS, **run)
    out["stacked"] = dp_run(model, mesh, adam, DP_STEPS, stacked=True, **run)
    # the single-rank stacked step on the same batches, no collective
    state = stack_train_state(model, init_state(model, adam, JaxKey(0), device="cpu"))
    step = make_train_step_stacked(model, adam, DP_STEPS, model.packed.stackable())
    out["stacked_single"] = _np(step(state, data, torch.as_tensor(idx_mat), layout)[1])

    params = init_state(model, adam, JaxKey(0), device="cpu").params
    scan = make_dp_eval_scan_explicit(model, mesh)
    out["eval"] = _np(scan(params, data, torch.as_tensor(idx_mat[:4]), None, False, layout))
    sgd = create_optimizer("sgd", 0.1)
    out["sgd"] = dp_run(model, mesh, sgd, 1, **run)[1]
    state = make_train_step_unrolled(model, sgd, 1)(init_state(model, sgd, JaxKey(0), device="cpu"),
                                                    data, torch.as_tensor(idx_mat[:1]), layout)[0]
    out["sgd_single"] = {k: _np(v) for k, v in state.params.items()}

    live, _, _, _ = dp_setup(dict(DP_HP, deep_dropout=(0.8, 0.8, 0.8)))
    out["dropout"] = dp_run(live, mesh, adam, 2, **run)[0]

    fs = create_criteo_features(num_buckets=AUTO_BUCKETS)
    raw = synthetic_criteo_arrays(AUTO_ROWS, num_buckets=AUTO_BUCKETS, seed=9)
    x, y = split_xy(raw)
    t = ShardedTrainer(XDeepFM(fs, DP_HP), epoch=1, batch_size=64, random_seed=7, mesh=mesh,
                       steps_per_dispatch=2, stacked_tables=True, device="cpu")
    t.state = shard_init_state(t.model, t.optimizer, JaxKey(7), mesh, device="cpu")
    out["auto_route"] = (t._explicit_dp, t._train_step_stacked is not None)
    t.fit(x, y, random_seed_for_mini_batch=False)
    out["auto_loss"], out["auto_predict"] = t.last_mean_loss, t.predict(x)
    out["gate"] = (explicit_dp_supported(model, mesh), explicit_dp_supported(model, mesh12),
                   explicit_dp_supported(model, mesh, embedding_exchange="dedup"))
    return out
