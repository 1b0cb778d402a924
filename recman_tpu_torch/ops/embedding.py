"""Embedding lookups and the stacked-storage lookup with its sorted
segment-sum backward.

Counterpart of ``recman_tpu/ops/embedding.py``. The forward of every
lookup is a plain row gather, as in the reference (:528-535). Its
gradient:

- ``packed_lookup_stacked_split`` (the stacked-storage path of the train
  step, reference :970-1034) is a ``torch.autograd.Function`` whose
  backward sorts the ids, permutes the cotangents into the transposed
  (T, C, N) layout and runs the batched segment sum, kernel K3
  (``ops/segment_matmul.py``), once over all tables.
- ``embedding_lookup`` and ``embedding_lookup_grouped`` keep plain
  autograd of the gather (the reference's CPU scatter path); routing them
  through K3 and K6 is later work.

``QuantTable`` tables, the split-lookup and dedup contexts and the
one-concat stacked form (``STACKED_SPLIT_CONCAT = False``) are not ported.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .segment_matmul import segment_matmul_from_sorted_batched

_state = threading.local()


@contextlib.contextmanager
def stacked_tables(names: tuple, stack):
    """Run packed lookups against ONE stacked (T, V, k) table leaf.

    ``names``: feature names in stack order; they must be the packed
    layer's full packable set (``PackedEmbeddingLinear.stackable``) for
    the layer to take the stack. The stacked train step installs this
    around ``model.loss`` with the step's stacked parameter."""
    prev = getattr(_state, "stacked", None)
    _state.stacked = (tuple(names), stack)
    try:
        yield
    finally:
        _state.stacked = prev


def _stacked_ctx():
    return getattr(_state, "stacked", None)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows ``ids`` (any shape, int32 or int64) from ``table`` (V, k)
    -> ids.shape + (k,)."""
    rows = table.index_select(0, ids.reshape(-1))
    return rows.reshape(*ids.shape, table.shape[1])


def embedding_lookup_grouped(tables, ids_list) -> list:
    """One lookup per (table, ids) pair. The reference batches same-shape
    tables for its backward; the forward values are the same."""
    return [embedding_lookup(t, i) for t, i in zip(tables, ids_list)]


class _StackedGatherSplit(torch.autograd.Function):
    """Per-table [stack[i] | w_cols[i]] rows; the reference's
    ``_stacked_gather_split`` custom_vjp (:970-1021)."""

    @staticmethod
    def forward(ctx, stack, w_cols, ids_mat):
        t, v, k = stack.shape
        flat = (ids_mat.long() + v * torch.arange(t, device=ids_mat.device)[:, None]).reshape(-1)
        rows = torch.cat([
            stack.reshape(t * v, k).index_select(0, flat),
            w_cols.reshape(t * v).index_select(0, flat)[:, None],
        ], dim=1)  # (T*N, k+1): the rows a [table | w] concat-then-gather gives
        ctx.save_for_backward(ids_mat)
        ctx.shape = (t, v, k)
        return rows.reshape(t, ids_mat.shape[1], k + 1)

    @staticmethod
    def backward(ctx, grad):
        (ids_mat,) = ctx.saved_tensors
        t, v, k = ctx.shape
        n = ids_mat.shape[1]
        # one batched stable sort for all tables (sort_key_val with an iota
        # in the reference), the cotangents permuted straight into the
        # kernel's transposed (T, C, N) layout, one K3 launch
        sids, order = torch.sort(ids_mat.to(torch.int32), dim=1, stable=True)
        sg_t = torch.gather(grad.transpose(1, 2), 2, order[:, None, :].expand(t, k + 1, n))
        grads = segment_matmul_from_sorted_batched(sids.contiguous(), sg_t.contiguous(), v)
        return grads[:, :k, :].transpose(1, 2), grads[:, k, :], None


def packed_lookup_stacked_split(stack, w_cols, ids_list) -> list:
    """Stacked-storage packed lookup: ``stack`` (T, V, k), ``w_cols`` (T, V)
    linear-weight columns, ``ids_list`` T (N,) id vectors -> T (N, k+1)
    packed rows. The backward reaches the stack and the w columns through
    one sort, one permute and one K3 launch."""
    ids_mat = torch.stack([i.reshape(-1) for i in ids_list])
    return list(_StackedGatherSplit.apply(stack, w_cols, ids_mat).unbind(0))
