"""Explicit data-parallel train and eval steps, with the port's kernels on
every rank.

Counterpart of ``recman_tpu/parallel/train_explicit.py``. The reference
needs this path because its GSPMD steps run under ``fused_grad(False)``:
the XLA partitioner cannot split a Pallas call. Here every collective is
explicit, so each rank runs the single-card hot path on its rows as it is
(the fused lookups, K3 over stacked or same-shape tables, K1 and K2 for
the CIN chain), and the only collectives are all-reduces over the data
group:

    loss math   local_obj_d = sum_i(w_i * per_ex_i) / W_global
                              + L2(params) / n_data_ranks
                loss        = sum_d(local_obj_d)       (exact: the L2
                              split telescopes back to one L2)
    gradients   g = sum_d(d local_obj_d / d params)

with ``W_global`` the all-reduced sum of the batch's weights. Params and
optimizer state stay replicated; every rank applies the identical update.

Each data rank takes columns ``[d B/D, (d+1) B/D)`` of every row of the
global (steps, B) index matrix, the block ``in_specs=P(None, DATA_AXIS)``
hands shard d. Dropout: with more than one data rank, each rank draws its
masks from a generator seeded from the step's generator, the step and its
data index ``d`` (never its rank, so the ranks of one data group draw the
same masks); with one data rank the step's generator is used as it is.

Scope: meshes whose model axis is 1 and models with the base
``Model.loss`` (``explicit_dp_supported``); row-sharded tables take the
steps of ``train_pjit.py``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..models.base import Model
from ..ops.embedding import stacked_tables
from ..training.train_step import (
    STACKED_KEY,
    TrainState,
    _eval_generator,
    apply_updates,
    gather_batch,
    unpack_batch,
    value_and_grads,
)
from ..utils.numerics import bce_per_example, mse_per_example
from .collectives import all_gather, all_reduce
from .distributed import check_finite
from .mesh import DATA_AXIS, MODEL_AXIS


def explicit_dp_supported(model, mesh, embedding_exchange="psum") -> bool:
    """Static eligibility: pure-DP mesh + base-Model loss + psum exchange
    (there are no sharded tables to exchange against)."""
    if mesh.shape.get(MODEL_AXIS, 1) != 1:
        return False
    if embedding_exchange != "psum":
        return False
    return type(model).loss is Model.loss


def per_example(model, y, preds):
    if model.task == "classification":
        return bce_per_example(y, preds)
    return mse_per_example(y, preds)


def rank_generator(generator, step: int, mesh):
    """This data rank's dropout generator for one step: ``generator`` itself
    on a one-wide data axis, else a generator on its device seeded from its
    seed, the step and the data index."""
    if generator is None or mesh.shape[DATA_AXIS] == 1:
        return generator
    seed = np.random.SeedSequence([generator.initial_seed(), step, mesh.data_index])
    return torch.Generator(device=generator.device).manual_seed(
        int(seed.generate_state(1, np.uint64)[0] % 2**63))


def rank_batch(mesh, data, idx, layout=()):
    """This data rank's columns of one index row: (batch, weights)."""
    lb = idx.shape[0] // mesh.shape[DATA_AXIS]
    d = mesh.data_index
    batch, weights = gather_batch(data, idx[d * lb:(d + 1) * lb])
    if layout:
        batch = unpack_batch(batch, layout)
    return batch, weights


def dp_grads(model, mesh, params, batch, weights, generator, names=None):
    """One rank's local objective and the data group's summed gradients:
    (loss summed over the data group, {name: gradient})."""
    d_n = mesh.shape[DATA_AXIS]
    w_global = all_reduce(weights.sum(), mesh, DATA_AXIS, "weights").clamp_min(1.0)

    def local_obj(p):
        ctx = stacked_tables(names, p[STACKED_KEY]) if names else contextlib.nullcontext()
        with ctx:
            preds = model.apply(p, batch, training=True, generator=generator)
            local_sum = torch.sum(per_example(model, batch["y"], preds) * weights)
            # the L2 split over the data ranks: the sums telescope back to one
            return local_sum / w_global + model.l2(p) / d_n

    obj, grads = value_and_grads(local_obj, params)
    with torch.no_grad():
        grads = {k: all_reduce(g, mesh, DATA_AXIS, "grad") for k, g in grads.items()}
        loss = all_reduce(obj, mesh, DATA_AXIS, "loss")
    check_finite(loss, grads)
    return loss, grads


def make_dp_train_step_explicit(model, optimizer, mesh, unroll: int = 1,
                                stacked_names: tuple | None = None):
    """(state, data, idx_mat (unroll, B), layout) -> (state, (unroll,)
    losses). ``data`` is the whole dataset on every rank (the replicated
    layout) and state leaves are replicated; each rank gathers its B/D
    rows of every batch. ``stacked_names``: the params are in stacked
    storage (``training.stack_table_params``) and the loss runs under
    ``stacked_tables``, so each rank runs one K3 a step."""
    assert unroll >= 1
    names = tuple(stacked_names) if stacked_names else None

    def step_fn(state: TrainState, data: dict, idx_mat, layout=()):
        losses = []
        params, opt_state = state.params, state.opt_state
        for i in range(unroll):
            batch, weights = rank_batch(mesh, data, idx_mat[i], layout)
            gen = rank_generator(state.generator, state.step + i, mesh)
            loss, grads = dp_grads(model, mesh, params, batch, weights, gen, names)
            with torch.no_grad():
                updates, opt_state = optimizer.update(grads, opt_state, params)
                params = apply_updates(params, updates)
            losses.append(loss)
        state = TrainState(params, opt_state, state.step + unroll, state.generator)
        return state, torch.stack(losses)

    return step_fn


def gather_preds(preds, mesh):
    """(batches, B/D) per data rank -> flat (batches * B,) on every rank, in
    the global index matrix's order."""
    d_n = mesh.shape[DATA_AXIS]
    every = all_gather(preds, mesh, DATA_AXIS, "preds").reshape(d_n, *preds.shape)
    return every.transpose(0, 1).reshape(-1)


def make_dp_eval_scan_explicit(model, mesh, stacked_names: tuple | None = None):
    """Whole-dataset eval, per data rank: (params, data, idx_mat, override,
    training, layout) -> flat predictions of every batch, on every rank,
    matching ``make_eval_scan``'s contract. K1 runs on each rank's rows."""
    names = tuple(stacked_names) if stacked_names else None

    def scan_fn(params, data, idx_mat, override, training: bool, layout=()):
        generator = _eval_generator(params, training)
        ctx = stacked_tables(names, params[STACKED_KEY]) if names else contextlib.nullcontext()
        outs = []
        with torch.no_grad(), ctx:
            for idx in idx_mat:
                batch, _ = rank_batch(mesh, data, idx, layout)
                outs.append(model.apply(params, batch, training=training, generator=generator,
                                        linear_override=override))
            return gather_preds(torch.stack(outs), mesh)

    return scan_fn
