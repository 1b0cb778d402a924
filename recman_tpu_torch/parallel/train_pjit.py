"""Row-sharded train and eval steps, and ``ShardedTrainer`` over a mesh.

Counterpart of ``recman_tpu/parallel/train_pjit.py``. The reference's GSPMD
steps lower ``model.loss`` on the global batch and let the XLA partitioner
insert the collectives; the port writes the same objective out per rank:

- each data rank takes its columns of the batch's index row (the
  replicated layout: the whole dataset on every rank; ``dataset_sharded``:
  the rank's own block of rows and a per-block local index matrix);
- params follow ``sharding.param_specs``: large embedding tables, their
  bias tables and the vocab-length ``linear_w`` hold one row block per
  model rank; dense towers are replicated;
- the forward runs under ``ops.embedding.dedup_exchange``, so every lookup
  against a block takes the masked gather + all-reduce ("psum") or the
  deduped all-gather ("dedup") over the model group, and nothing is packed;
- the objective is ``sum(w * per_ex) / W_global + L2 / D`` per rank, as in
  ``train_explicit.py``; the model ranks of one data group compute its
  dense part redundantly on identical rows, one objective, so the
  exchanges' backwards do not sum over them (``collectives.py``), and a
  block's L2 is a sum over the blocks while a replicated leaf's is counted
  once per model group;
- every gradient (a block's and a replicated leaf's) is summed over the
  data group, so the optimizer's state for a block is that block's, and
  the loss over the whole mesh.

The port's kernels stay on: the reference gates its Pallas calls off here
only because the partitioner cannot split them. K1 and K2 run on every
rank's rows; a replicated same-shape group keeps K3. Lookups against
blocks run their exchange's index ops and autograd's gather backward.

``ShardedTrainer`` picks the explicit DP steps (``train_explicit.py``) on a
pure-DP mesh (``spmd="auto"``/``"explicit_dp"``), the row-sharded steps
here otherwise (``spmd="gspmd"``, the reference's name).

Not ported yet (``ROADMAP.md`` queue 1), and refused: tensor-parallel DNN
towers, ``fit(resilience=)``, ``save``/``restore``, the stream methods, a
model whose loss is not the base loss (DIEN), QR tables on the mesh, and
an optimizer with per-leaf norms (lamb) over row blocks.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..models.base import Model
from ..ops.embedding import dedup_exchange
from ..training.train_step import (
    Lamb,
    MultiTransform,
    TrainState,
    _eval_generator,
    apply_updates,
    create_optimizer,
    init_params_and_seed,
    value_and_grads,
)
from ..training.trainer import Trainer
from .collectives import all_reduce
from .distributed import check_finite, rank_device
from .mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from .sharding import _refuse_tp, param_specs, place_params
from .train_explicit import (
    explicit_dp_supported,
    gather_preds,
    make_dp_eval_scan_explicit,
    make_dp_train_step_explicit,
    per_example,
    rank_batch,
    rank_generator,
)

log = logging.getLogger(__name__)

_QUEUE = "not ported yet: ROADMAP.md queue 1"


def _not_ported(what):
    raise NotImplementedError(f"ShardedTrainer: {what} is {_QUEUE}")


def shard_init_state(model, optimizer, generator, mesh, row_shard_threshold=50_000,
                     tp_dense_threshold=None, device=None) -> TrainState:
    """Params from ``generator`` (a torch.Generator, or a ``utils.JaxKey``
    for the reference's params of that key), this rank's blocks of them per
    ``param_specs``, then the optimizer state of the placed params (a
    block's moments are its own)."""
    return _init_sharded(model, optimizer, generator, mesh, row_shard_threshold,
                         tp_dense_threshold, device)[0]


def _init_sharded(model, optimizer, generator, mesh, row_shard_threshold, tp_dense_threshold,
                  device):
    _refuse_tp(tp_dense_threshold)
    device = rank_device(device)
    params, seed = init_params_and_seed(model, generator, device)
    specs = param_specs(params, row_shard_threshold)
    return shard_state(optimizer, params, mesh, specs, seed, device), specs


def shard_state(optimizer, params: dict, mesh, specs: dict, seed: int, device) -> TrainState:
    """A TrainState of this rank's blocks of ``params`` (full arrays, tensors
    or numpy) and a dropout generator seeded ``seed``."""
    if mesh.shape[MODEL_AXIS] > 1 and any(specs.values()):
        _refuse_per_leaf_norms(optimizer)
    local = place_params(params, mesh, specs)
    local = {k: torch.as_tensor(v).to(device) for k, v in local.items()}
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(local, optimizer.init(local), 0, generator)


def _refuse_per_leaf_norms(optimizer):
    inner = optimizer.transforms.values() if isinstance(optimizer, MultiTransform) else [optimizer]
    if any(isinstance(t, Lamb) for t in inner):
        _not_ported("lamb's per-leaf trust ratio over row-sharded blocks")


def make_local_gather(mesh):
    """(data, idx) -> (batch, weights) of this data rank: its columns of one
    index row, shard-major as ``_batch_index_matrix`` lays them out, into
    ``data`` (its block of rows when ``dataset_sharded``; the gather is
    local either way)."""
    return lambda data, idx: rank_batch(mesh, data, idx)


def _exchange(mesh, params, specs, embedding_exchange, dedup_capacity):
    cap = dedup_capacity() if callable(dedup_capacity) else dedup_capacity
    blocks = {k: v for k, v in params.items() if specs[k]}
    return dedup_exchange(mesh, blocks, capacity=cap, exchange=embedding_exchange)


def sharded_grads(model, mesh, specs, params, batch, weights, generator,
                  embedding_exchange="psum", dedup_capacity=None):
    """One rank's part of the global objective and the summed gradients:
    (the mesh's loss, {name: gradient summed over the data group})."""
    d_n = mesh.shape[DATA_AXIS]
    w_global = all_reduce(weights.sum(), mesh, DATA_AXIS, "weights").clamp_min(1.0)

    def local_obj(p):
        with _exchange(mesh, p, specs, embedding_exchange, dedup_capacity):
            preds = model.apply(p, batch, training=True, generator=generator)
        data_part = torch.sum(per_example(model, batch["y"], preds) * weights) / w_global
        return data_part + model.l2(p) / d_n

    obj, grads = value_and_grads(local_obj, params)
    with torch.no_grad():
        grads = {k: all_reduce(g, mesh, DATA_AXIS, "grad") for k, g in grads.items()}
        # the loss: each data rank's objective once (from model rank 0), and
        # the other model ranks' blocks' L2
        if mesh.model_index == 0:
            mine = obj
        else:
            mine = torch.as_tensor(model.l2(
                {k: v if specs[k] else v.new_zeros(()) for k, v in params.items()}),
                device=obj.device) / d_n
        loss = all_reduce(mine, mesh, "mesh", "loss")
    check_finite(loss, grads)
    return loss, grads


def make_sharded_train_step(model, optimizer, mesh, specs, embedding_exchange="psum",
                            dedup_capacity=None):
    """(state, data, idx (B,) or shard-major (D * B/D,), layout) -> (state,
    loss): one row-sharded step. ``specs``: the params' ``param_specs``;
    ``dedup_capacity``: an int, None (the exchange's default) or a
    zero-arg callable read at every step."""

    def step_fn(state: TrainState, data: dict, idx, layout=()):
        batch, weights = rank_batch(mesh, data, idx, layout)
        gen = rank_generator(state.generator, state.step, mesh)
        loss, grads = sharded_grads(model, mesh, specs, state.params, batch, weights, gen,
                                    embedding_exchange, dedup_capacity)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1, state.generator), loss

    return step_fn


def make_sharded_train_epoch(model, optimizer, mesh, specs, embedding_exchange="psum",
                             dedup_capacity=None):
    """The steps of a whole epoch: (state, data, idx_mat, layout) -> (state,
    (steps,) losses)."""
    step = make_sharded_train_step(model, optimizer, mesh, specs, embedding_exchange,
                                   dedup_capacity)

    def epoch_fn(state, data, idx_mat, layout=()):
        losses = []
        for idx in idx_mat:
            state, loss = step(state, data, idx, layout)
            losses.append(loss)
        return state, torch.stack(losses)

    return epoch_fn


def make_sharded_eval_step(model, mesh, specs, embedding_exchange="psum", dedup_capacity=None):
    """(params, data, idx, override, training, layout) -> the batch's
    predictions, on every rank."""
    scan = make_sharded_eval_scan(model, mesh, specs, embedding_exchange, dedup_capacity)
    return lambda params, data, idx, override, training, layout=(): scan(
        params, data, idx[None], override, training, layout)


def make_sharded_eval_scan(model, mesh, specs, embedding_exchange="psum", dedup_capacity=None):
    """Whole-dataset eval: (params, data, idx_mat, override, training,
    layout) -> flat predictions of every batch, on every rank (each data
    rank forwards its columns under the exchange; an all-gather over the
    data group assembles them)."""

    def scan_fn(params, data, idx_mat, override, training: bool, layout=()):
        generator = _eval_generator(params, training)
        outs = []
        with torch.no_grad(), _exchange(mesh, params, specs, embedding_exchange, dedup_capacity):
            for idx in idx_mat:
                batch, _ = rank_batch(mesh, data, idx, layout)
                outs.append(model.apply(params, batch, training=training, generator=generator,
                                        linear_override=override))
            return gather_preds(torch.stack(outs), mesh)

    return scan_fn


class ShardedTrainer(Trainer):
    """Trainer over a (data, model) mesh of torch.distributed ranks; every
    rank of the mesh constructs it and calls each method in step.
    batch_size must divide the data axis. ``device``: this rank's (default
    ``cuda:LOCAL_RANK``); ``mesh``: default ``make_mesh()`` over the whole
    world, a one-rank group when there is none.

    ``multihost_feed`` (default: on when the launcher's world spans more
    than one host, ``WORLD_SIZE != LOCAL_WORLD_SIZE``): ``X`` passed to
    fit/predict holds this rank's data group's rows only, the same number
    on every rank (pad beforehand), and needs ``dataset_sharded``. Off,
    every rank is passed the whole dataset, as every JAX device sees it."""

    def __init__(self, model, hparams=None, metrics=(), epoch=10, batch_size=64,
                 random_seed=2019, eval_in_training_mode=False, mesh=None,
                 row_shard_threshold=50_000, tp_dense_threshold=None,
                 dataset_sharded=False, embedding_exchange="psum",
                 dedup_capacity=None, multihost_feed=None, spmd="auto",
                 steps_per_dispatch=1, stacked_tables=None, device=None):
        _refuse_tp(tp_dense_threshold)
        if type(model).loss is not Model.loss:
            _not_ported(f"{type(model).__name__}'s own loss on a mesh")
        self.device = rank_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(device=self.device)
        data_n = self.mesh.shape[DATA_AXIS]
        if batch_size % data_n:
            raise ValueError(f"batch_size {batch_size} must divide data axis {data_n}")
        if embedding_exchange not in ("psum", "dedup"):
            raise ValueError(f"embedding_exchange {embedding_exchange!r}: 'psum' or 'dedup'")
        self.row_shard_threshold = row_shard_threshold
        self.dataset_sharded = dataset_sharded
        if multihost_feed is None:
            import os

            multihost_feed = os.environ.get("WORLD_SIZE", "1") != os.environ.get(
                "LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1"))
        self.multihost_feed = multihost_feed
        if multihost_feed and not dataset_sharded:
            raise ValueError("multihost_feed requires dataset_sharded")

        hp = hparams or {}
        self.model = model
        self.hparams = hp
        self.metrics = tuple(metrics)
        self.epoch = epoch
        self.batch_size = batch_size
        self.random_seed = random_seed
        self.eval_in_training_mode = eval_in_training_mode
        self.epoch_in_one_dispatch = False
        self.steps_per_dispatch = 1  # raised below on the explicit DP route
        self._train_step_unrolled = None
        self._train_step_stacked = None
        self.stacked_tables = "off"  # "auto" below on the explicit DP route

        from ..config import BaseHyperParameters

        self.optimizer = create_optimizer(
            hp.get(BaseHyperParameters.Optimizer, "adam"),
            hp.get(BaseHyperParameters.LearningRate, 0.001),
        )
        self.embedding_exchange = embedding_exchange
        # the dedup exchange's per-rank unique-row bound; None = sized on the
        # first fit batch (auto_dedup_capacity), the 4N/S default before it
        self.dedup_capacity = dedup_capacity
        self._dedup_checked = False
        self.state, self.specs = _init_sharded(
            model, self.optimizer, torch.Generator().manual_seed(random_seed), self.mesh,
            row_shard_threshold, None, self.device)
        if self.mesh.shape[MODEL_AXIS] > 1 and any(
                self.specs[k] for k in self.specs if k.endswith("_feat_embed_q")):
            _not_ported("a row-sharded QR quotient table")

        if spmd not in ("auto", "explicit_dp", "gspmd"):
            raise ValueError(f"spmd {spmd!r}: 'auto', 'explicit_dp' or 'gspmd'")
        eligible = (not dataset_sharded and not multihost_feed
                    and explicit_dp_supported(model, self.mesh, embedding_exchange))
        if spmd == "explicit_dp" and not eligible:
            raise ValueError(
                "spmd='explicit_dp' needs a pure-DP mesh (model axis 1), "
                "embedding_exchange='psum', a replicated dataset and a "
                "base-Model loss")
        self._explicit_dp = eligible and spmd in ("auto", "explicit_dp")
        if self._explicit_dp:
            self._init_explicit_dp(int(steps_per_dispatch), stacked_tables)
        else:
            cap = lambda: self.dedup_capacity  # noqa: E731 - read at every step
            args = (self.mesh, self.specs, embedding_exchange, cap)
            self._train_step = make_sharded_train_step(model, self.optimizer, *args)
            self._train_epoch = make_sharded_train_epoch(model, self.optimizer, *args)
            self._eval_step = make_sharded_eval_step(model, *args)
            self._eval_scan = make_sharded_eval_scan(model, *args)
        log.info("ShardedTrainer on %s; %d/%d params row-sharded; spmd=%s", self.mesh,
                 sum(1 for s in self.specs.values() if s), len(self.specs),
                 "explicit_dp" if self._explicit_dp else "gspmd")

    def _init_explicit_dp(self, steps_per_dispatch, stacked_tables):
        model, opt, mesh = self.model, self.optimizer, self.mesh
        step1 = make_dp_train_step_explicit(model, opt, mesh, unroll=1)

        def one_step(state, data, idx, layout=()):
            state, losses = step1(state, data, idx[None], layout)
            return state, losses[0]

        def epoch(state, data, idx_mat, layout=()):
            return make_dp_train_step_explicit(model, opt, mesh, unroll=len(idx_mat))(
                state, data, idx_mat, layout)

        self._train_step = one_step
        self._train_epoch = epoch
        self._eval_scan = make_dp_eval_scan_explicit(model, mesh)
        self._eval_step = lambda params, data, idx, override, training, layout=(): \
            self._eval_scan(params, data, idx[None], override, training, layout)
        self.steps_per_dispatch = steps_per_dispatch
        # stacked storage in the grouped-step loop follows the single-card
        # gate ("auto": where the fused backward is active); True/False force
        self.stacked_tables = "auto" if stacked_tables is None else stacked_tables
        if steps_per_dispatch > 1:
            u = steps_per_dispatch
            self._train_step_unrolled = make_dp_train_step_explicit(model, opt, mesh, unroll=u)
            packed = getattr(model, "packed", None)
            names = packed.stackable() if packed is not None else None
            if names:
                self._train_step_stacked = make_dp_train_step_explicit(
                    model, opt, mesh, unroll=u, stacked_names=names)

    # -- not ported yet (ROADMAP.md queue 1) ---------------------------------
    def fit(self, *args, resilience=None, **kwargs):
        if resilience is not None:
            _not_ported("fit(resilience=...)")
        return super().fit(*args, **kwargs)

    def save(self, directory):
        _not_ported("save (sharded checkpoints)")

    def restore(self, directory):
        _not_ported("restore (sharded checkpoints)")

    def fit_stream(self, *args, **kwargs):
        _not_ported("fit_stream (the sharded stream path)")

    def predict_stream(self, *args, **kwargs):
        _not_ported("predict_stream (the sharded stream path)")

    def evaluate_stream(self, *args, **kwargs):
        _not_ported("evaluate_stream (the sharded stream path)")

    def calibrate(self, X, max_rows=65536) -> bool:
        if any("_dice_mean_" in k for k in self.state.params) and any(self.specs.values()):
            _not_ported("calibrate with row-sharded tables")
        return super().calibrate(X, max_rows)

    # -- dedup-exchange capacity guard ---------------------------------------
    def _dedup_feature_specs(self):
        """(label, batch_key, clip_negative, vocab_rows) for every embedding
        lookup that takes the dedup exchange. The linear tower takes the
        psum exchange (``layers/linear.py``), so it is not listed."""
        from ..features import MultiValCsvFeat, MultiValSparseFeat

        emb = getattr(self.model, "embeddings", None)
        if emb is None:
            return
        model_n = self.mesh.shape[MODEL_AXIS]
        for feat in emb.feats:
            name = f"{emb.prefix}{feat.name}_feat_embed"
            if not emb._owns_table(feat) or not self.specs.get(name):
                continue
            clip = isinstance(feat, (MultiValCsvFeat, MultiValSparseFeat))
            yield feat.name, feat.name, clip, self.state.params[name].shape[0] * model_n

    def _dedup_local_counts(self, data, idx, layout=()):
        """Per dedup-routed lookup of this data rank's rows of one batch:
        (label, ids in the rank's segment, unique-row counts per model
        rank)."""
        batch, _ = rank_batch(self.mesh, data, torch.as_tensor(idx, device=self.device), layout)
        model_n = self.mesh.shape[MODEL_AXIS]
        out = []
        for label, key, clip, vocab_rows in self._dedup_feature_specs():
            ids = batch.get(key)
            if ids is None or ids.dtype.is_floating_point:
                continue
            ids = ids.cpu().numpy().reshape(-1)
            if clip:
                ids = np.maximum(ids, 0)
            owners = np.clip(np.unique(ids) // (vocab_rows // model_n), 0, model_n - 1)
            out.append((label, ids.size, np.bincount(owners, minlength=model_n)))
        return out

    def dedup_overflow_report(self, data, idx, layout=()) -> dict:
        """{feature: unique ids over the capacity} for one batch, summed over
        the data ranks' segments: what the exchange would zero (it does so
        silently, so training checks the first batch). Every rank of the
        mesh must call it."""
        from .shard_lookup import default_capacity

        model_n = self.mesh.shape[MODEL_AXIS]
        counts = self._dedup_local_counts(data, idx, layout)
        over = []
        for _, n_local, c in counts:
            cap = min(self.dedup_capacity or default_capacity(n_local, model_n), n_local)
            over.append(int(np.maximum(c - cap, 0).sum()))
        total = all_reduce(torch.tensor(over, dtype=torch.int64, device=self.device),
                           self.mesh, DATA_AXIS, "guard")
        return {label: int(v) for (label, _, _), v in zip(counts, total.tolist())}

    def auto_dedup_capacity(self, data, idx, layout=(), safety=1.5) -> int:
        """``safety`` x the worst unique-row count any model rank owns in any
        data rank's segment of one batch, over every dedup-routed lookup
        (``shard_lookup.capacity_from_sample`` per segment, the granularity
        the exchange runs at). Every rank of the mesh must call it."""
        worst = max([1] + [int(c.max()) for _, _, c in self._dedup_local_counts(data, idx, layout)])
        worst = all_reduce(torch.tensor(worst, device=self.device), self.mesh, "mesh", "guard",
                           op="max")
        return int(np.ceil(int(worst) * float(safety)))

    def _check_dedup_overflow(self, data, idx, layout=()):
        bad = {k: v for k, v in self.dedup_overflow_report(data, idx, layout).items() if v}
        if bad:
            raise ValueError(
                "dedup embedding exchange would silently DROP rows this "
                f"batch (unique ids per shard over capacity): {bad}. "
                "Range-partitioned ownership needs roughly uniform id "
                "spread — raise dedup_capacity (capacity=batch_size is "
                "unconditionally exact) or use embedding_exchange='psum'.")

    def fit_on_batch(self, data: dict, idx, layout=()):
        # size and check the capacity once per trainer, on the first batch
        if self.embedding_exchange == "dedup" and not self._dedup_checked:
            if self.dedup_capacity is None:
                self.dedup_capacity = self.auto_dedup_capacity(data, idx, layout)
                model_n = self.mesh.shape[MODEL_AXIS]
                n_local = self.batch_size // self.mesh.shape[DATA_AXIS]
                breakeven = n_local / max(model_n, 1)
                log.info("dedup capacity auto-sized from first batch: %d "
                         "(traffic ratio vs psum: %.2f)", self.dedup_capacity,
                         self.dedup_capacity * model_n / max(n_local, 1))
                if model_n > 1 and self.dedup_capacity >= breakeven:
                    log.warning(
                        "measured dedup capacity %d >= breakeven %d "
                        "(capacity*S/N is the dedup:psum traffic ratio): "
                        "this id distribution concentrates uniques on few "
                        "shards, so embedding_exchange='psum' would move "
                        "fewer bytes. For ranked vocabularies, encode with "
                        "FeatureSet.initialize(shuffle_vocab=<seed>) to "
                        "spread hot rows (docs/sharding_guide.md).",
                        self.dedup_capacity, int(breakeven))
            self._check_dedup_overflow(data, idx, layout)
            self._dedup_checked = True
        return super().fit_on_batch(data, idx, layout)

    # -- data layouts --------------------------------------------------------
    def _feed(self):
        """(data ranks per feed, this feed's index): a multihost feed is
        one data rank's rows; otherwise every rank is fed the whole data."""
        d_n = self.mesh.shape[DATA_AXIS]
        return (1, self.mesh.data_index) if self.multihost_feed else (d_n, 0)

    def _to_device(self, X, y=None):
        if not self.dataset_sharded:
            return super()._to_device(X, y)
        # this rank's contiguous block of the rows padded to a multiple of
        # the data axis; index matrices never address the pad (-1)
        data, layout = self._encode(X, y)
        spp, _ = self._feed()
        n = int(next(iter(data.values())).shape[0])
        local_n = -(-n // spp)
        d = 0 if self.multihost_feed else self.mesh.data_index
        out = {}
        for k, v in data.items():
            if n != spp * local_n:
                v = np.pad(v, [(0, spp * local_n - n)] + [(0, 0)] * (v.ndim - 1))
            out[k] = torch.as_tensor(v[d * local_n:(d + 1) * local_n]).to(self.device)
        return out, layout

    def _batch_index_matrix(self, n: int, shuffle_seed=None) -> np.ndarray:
        """Per-block LOCAL index rows when dataset_sharded: batch b's row is
        the concat over data ranks d of local_bs indices into block d (-1
        pad); shuffles run within each block; eval (no seed) is sequential.
        Under multihost_feed ``n`` is the rank's rows and the seeded matrix
        comes out the same on every rank."""
        if not self.dataset_sharded:
            return super()._batch_index_matrix(n, shuffle_seed)
        d_n = self.mesh.shape[DATA_AXIS]
        spp, _ = self._feed()
        local_n = -(-n // spp)
        local_bs = self.batch_size // d_n
        num_batches = local_n // local_bs + 1
        rs = np.random.RandomState(shuffle_seed) if shuffle_seed is not None else None
        idx = np.full((num_batches * local_bs, d_n), -1, dtype=np.int32)
        for d in range(d_n):
            valid = min(max(n - (d % spp) * local_n, 0), local_n)
            order = np.arange(valid, dtype=np.int32)
            if rs is not None:
                order = rs.permutation(valid).astype(np.int32)
            idx[:valid, d] = order
        # (num_batches, d_n * local_bs), shard-major within each batch
        return (idx.reshape(num_batches, local_bs, d_n).transpose(0, 2, 1)
                .reshape(num_batches, d_n * local_bs))

    def _steps_per_epoch(self, n: int) -> int:
        if not self.dataset_sharded:
            return super()._steps_per_epoch(n)
        spp, _ = self._feed()
        return -(-n // spp) // (self.batch_size // self.mesh.shape[DATA_AXIS]) + 1

    def _unshard_preds(self, preds: np.ndarray, n: int) -> np.ndarray:
        """Flat eval output is [batch, data rank, j]-ordered when
        dataset_sharded: back to row order. Under multihost_feed each rank
        returns the predictions of its own ``n`` rows."""
        if not self.dataset_sharded:
            return preds[:n]
        d_n = self.mesh.shape[DATA_AXIS]
        spp, pid = self._feed()
        local_bs = self.batch_size // d_n
        nb = preds.shape[0] // (d_n * local_bs)
        per_shard = preds.reshape(nb, d_n, local_bs).transpose(1, 0, 2).reshape(d_n, nb * local_bs)
        local_n = -(-n // spp)
        return per_shard[pid * spp:(pid + 1) * spp, :local_n].reshape(-1)[:n]
