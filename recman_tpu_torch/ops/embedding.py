"""Embedding lookups with sorted segment-sum gradients.

Counterpart of ``recman_tpu/ops/embedding.py``. The forward of every
lookup is a plain row gather, as in the reference (:528-535). When the
fused backward is active (``fused_grad``; by default on for CUDA tensors,
as the reference's is on for its TPU) each lookup is a
``torch.autograd.Function`` whose backward stably sorts the ids, permutes
the cotangent rows into that order and then, by ``grad_kernel``:

- ``embedding_lookup`` (reference ``_lookup``, :527-606): ``"segmat"``
  runs K6 (``ops/segment_matmul.py:segment_matmul_from_sorted``);
  ``"scatter"`` and ``"auto"`` add the sorted rows with ``index_add_``,
  the counterpart of the reference's sorted-hint scatter.
- ``embedding_lookup_multi`` (same-shape tables, reference
  ``_lookup_multi``, :738-901) and the stacked-storage lookups
  (``packed_lookup_stacked_split`` with per-table packed rows, and
  ``packed_lookup_stacked`` from one (T, V, C) concat, :904-1034): one
  batched sort, then K3 (``segment_matmul_from_sorted_batched``) once over
  all tables when ``_segmat_multi_active`` holds, else per-table
  ``index_add_``.
- ``packed_lookup_grouped`` (the split lookup, :1037-1175, under
  ``split_lookup``): per same-shape group, the table rows and each vector
  column are gathered apart, with no (V, k + n_vec) packed matrix; the
  backward sorts once and then runs K7
  (``segment_matmul_from_sorted_batched_vk``, row-major table grads) under
  ``SEGMAT_VK_OUT``, else K3 with the table grads as (V, k) views of its
  (k, V) rows, else per-table ``index_add_``.

With the fused backward off (the default on the CPU, as the reference's
is off there) a lookup is ``index_select`` under plain autograd.

The contexts are read when the forward runs, as the reference reads them
while tracing: autograd runs a CUDA backward on a thread of its own, where
this module's thread-local contexts are not set.

A ``QuantTable`` (int8 rows and per-row f32 scales, the quantized
serving tables of ``serving.Predictor.export(quantize_embeddings=
"runtime")``) goes through ``embedding_lookup``: the int8 rows are
gathered and dequantized after the gather, in plain PyTorch as in the
reference (:583-590). It has no gradient path.

In a sharded run (``utils.sharded_run``: the row-sharded train and eval
steps of ``parallel/train_pjit.py``) a lookup against a row-sharded table
block takes the run's ``exchange`` (``lookup_exchange``), the masked
gather + all-reduce ("psum") or the deduped all-gather ("dedup",
``parallel/shard_lookup.py``); the reference leaves "psum" to its
partitioner, which the port does not have.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..utils.sharded_run import current_run
from .segment_matmul import (
    segment_matmul_from_sorted,
    segment_matmul_from_sorted_batched,
    segment_matmul_from_sorted_batched_vk,
)

_state = threading.local()


def _mode():
    return getattr(_state, "mode", "auto")


@contextlib.contextmanager
def fused_grad(enabled: bool | None):
    """Force the custom lookup backward on or off (None = auto: on for
    tensors on a CUDA device)."""
    prev = _mode()
    _state.mode = "auto" if enabled is None else ("on" if enabled else "off")
    try:
        yield
    finally:
        _state.mode = prev


def _fused_active(device) -> bool:
    mode = _mode()
    if mode == "on":
        return True
    if mode == "off":
        return False
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def grad_kernel(kind: str):
    """Select the dense-table-gradient implementation: "auto" (default),
    "scatter" (sort, permute, ``index_add_``) or "segmat" (sort, permute,
    the segment-sum kernels K6 and K3). Ignored when the fused backward is
    inactive.

    "auto" routes the batched multi-table backward through K3 on CUDA when
    C >= 8 and keeps the scatter elsewhere (single lookups, narrow C), the
    reference's rule with "tpu" read as "cuda"."""
    assert kind in ("auto", "scatter", "segmat"), kind
    prev = getattr(_state, "grad_kernel", "auto")
    _state.grad_kernel = kind
    try:
        yield
    finally:
        _state.grad_kernel = prev


def _grad_kernel() -> str:
    return getattr(_state, "grad_kernel", "auto")


# "auto" for the split packed lookup (reference :124-135): off, as the
# reference's is off on its TPU, where the split form measured slower
# than concat-then-gather. "on" forces it, "off" the concat.
SPLIT_LOOKUP_AUTO_TPU = False


@contextlib.contextmanager
def split_lookup(kind: str):
    """How layers/packed.py assembles packed [table | vec...] rows: "auto"
    (default, ``SPLIT_LOOKUP_AUTO_TPU`` on CUDA), "on" (per-part gathers,
    no (V, k + m) packed concat: ``packed_lookup_grouped``) or "off"
    (concat, then one gather)."""
    assert kind in ("auto", "on", "off"), kind
    prev = getattr(_state, "split_lookup", "auto")
    _state.split_lookup = kind
    try:
        yield
    finally:
        _state.split_lookup = prev


def _split_lookup_active(device) -> bool:
    mode = getattr(_state, "split_lookup", "auto")
    if mode == "on":
        return True
    if mode == "off":
        return False
    return SPLIT_LOOKUP_AUTO_TPU and torch.device(device).type == "cuda"


# The split lookup's backward takes K7 (row-major table grads) when True
# and the batch is at most SEGMAT_SEGMENT_N rows; K3 and (V, k) views of
# its rows otherwise. False is the reference's default (:726-735).
SEGMAT_VK_OUT = False

# The reference's row limit of one segmat call (:162-168), a TPU VMEM
# bound. K3 takes any N in one launch here; the constant is kept only for
# the split backward's routing rule above.
SEGMAT_SEGMENT_N = 32_768

# Stacked storage builds per-table packed rows from slices of the stack
# (True, the reference's default, :1024-1027) or one (T, V, k + 1) concat
# (False, ``packed_lookup_stacked``).
STACKED_SPLIT_CONCAT = True


def _segmat_multi_active(c: int, device) -> bool:
    """Should a batched multi-table backward run K3 (reference :177-187)?"""
    kind = _grad_kernel()
    if kind == "segmat":
        return True
    if kind == "scatter":
        return False
    return torch.device(device).type == "cuda" and c >= 8


class _Exchange(NamedTuple):
    mesh: object
    kind: str  # "psum" or "dedup"
    capacity: int | None
    blocks: dict  # data_ptr of a row-sharded block -> (its rows, the counter's tag)


def _exchange_tag(name: str) -> str:
    if name.endswith("linear_w"):
        return "linear"
    return "bias" if name.endswith("_feat_bias") else "table"


def lookup_exchange(mesh, blocks: dict, capacity=None, exchange="dedup") -> _Exchange:
    """The exchange that a sharded run's lookups against row-sharded table
    blocks take (reference :191-207, which routes by the global table's
    shape).

    ``blocks``: {param name: this rank's block} of the row-sharded params
    (``parallel.sharding.param_specs``); a lookup takes the exchange when
    its table is one of them or a view of one from its first row (a bias
    block as (V, 1)). ``exchange``: "dedup" (``dedup_embedding_lookup``
    at ``capacity``, None = its default) or "psum"
    (``sharded_embedding_lookup``)."""
    assert exchange in ("psum", "dedup"), exchange
    return _Exchange(mesh, exchange, capacity, {
        t.data_ptr(): (t.shape[0], _exchange_tag(name)) for name, t in blocks.items()})


def _dedup_ctx():
    run = current_run()
    return None if run is None else run.exchange


def _exchanged(table):
    """The counter's tag when ``table`` is a row-sharded block in a sharded
    run with an exchange, else None."""
    ctx = _dedup_ctx()
    if ctx is None or isinstance(table, QuantTable):
        return None
    hit = ctx.blocks.get(table.data_ptr())
    return hit[1] if hit is not None and hit[0] == table.shape[0] else None


def exchange_lookup(tables: list, ids_list: list, tag: str) -> list:
    """Rows of row-sharded blocks through the context's exchange, one
    collective for all of them (``parallel/shard_lookup.py``)."""
    from ..parallel.shard_lookup import _dedup_rows, _psum_rows

    ctx = _dedup_ctx()
    if ctx.kind == "psum":
        return _psum_rows(tables, ids_list, ctx.mesh, tag)
    return _dedup_rows(tables, ids_list, ctx.mesh, ctx.capacity, tag)[0]


@contextlib.contextmanager
def stacked_tables(names: tuple, stack):
    """Run packed lookups against ONE stacked (T, V, k) table leaf.

    ``names``: feature names in stack order; they must be the packed
    layer's full packable set (``PackedEmbeddingLinear.stackable``) for
    the layer to take the stack. The stacked train step installs this
    around ``model.loss`` with the step's stacked parameter. Incompatible
    with an exchange."""
    if _dedup_ctx() is not None:
        raise RuntimeError("stacked_tables is incompatible with a lookup exchange")
    prev = getattr(_state, "stacked", None)
    _state.stacked = (tuple(names), stack)
    try:
        yield
    finally:
        _state.stacked = prev


def _stacked_ctx():
    return getattr(_state, "stacked", None)


class QuantTable(NamedTuple):
    """Symmetric per-row int8 embedding table for quantized serving
    (reference :248-272): passed in place of an f32 (V, k) table, it stays
    int8 on the device and is dequantized per looked-up row, after the
    gather: 4k/(k+4) times fewer table bytes than f32 (3.2 at k 16; the
    scale is one f32 per row). Lookup-only: a lookup whose scale requires
    a gradient raises."""

    q: torch.Tensor  # (V, k) int8
    scale: torch.Tensor  # (V,) f32

    @property
    def dtype(self):  # layers read table.dtype for their mask casts
        return self.scale.dtype

    @property
    def shape(self):
        return self.q.shape


def quantize_table_int8(a):
    """f32 (V, k) -> (int8 (V, k), f32 (V,) per-row symmetric scales); the
    reference's numpy code (:275-282), so the bytes are the reference's."""
    a = np.asarray(a)
    scale = np.maximum(np.abs(a).max(axis=1) / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.rint(a / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def _quant_lookup(table: QuantTable, ids):
    """int8 rows ``ids`` of ``table``, dequantized after the gather."""
    if table.scale.requires_grad:
        raise RuntimeError("a QuantTable is lookup-only: it has no gradient path")
    flat = ids.reshape(-1)
    rows = table.q.index_select(0, flat).to(table.scale.dtype)
    rows = rows * table.scale.index_select(0, flat)[:, None]
    return rows.reshape(*ids.shape, table.q.shape[1])


def _sorted_order(ids):
    """Stable sort of (..., N) ids along the last axis -> (int32 sorted
    ids, order), the reference's sort_key_val against an iota."""
    return torch.sort(ids.to(torch.int32), dim=-1, stable=True)


def _scatter_sorted_rows(sids, sg, vocab_size: int):
    """Sorted ids (N,) + permuted rows (N, C) -> (V, C) by ``index_add_``
    (the reference's sorted-hint scatter-add, :536-561 and :824-843)."""
    out = torch.zeros((vocab_size, sg.shape[1]), dtype=sg.dtype, device=sg.device)
    return out.index_add_(0, sids, sg)


class _Lookup(torch.autograd.Function):
    """Rows ``ids`` (N,) of ``table`` (V, k); the reference's ``_lookup``
    custom_vjp."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab_size = table.shape[0]
        ctx.segmat = _grad_kernel() == "segmat"
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        sids, order = _sorted_order(ids)
        sg = g.index_select(0, order).contiguous()
        if ctx.segmat:
            return segment_matmul_from_sorted(sids, sg, ctx.vocab_size), None
        return _scatter_sorted_rows(sids, sg, ctx.vocab_size), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows ``ids`` (any shape, int32 or int64) from ``table`` (V, k)
    -> ids.shape + (k,). The custom backward runs when the fused backward
    is active for the table's device. A ``QuantTable`` gathers int8 rows
    and dequantizes them after the gather (no gradient path)."""
    if isinstance(table, QuantTable):
        return _quant_lookup(table, ids)
    tag = _exchanged(table)
    if tag is not None:
        return exchange_lookup([table], [ids], tag)[0]
    return _local_lookup(table, ids)


def _local_lookup(table, ids):
    """``embedding_lookup`` of a tensor this rank holds whole, without the
    exchange."""
    flat = ids.reshape(-1)
    if _fused_active(table.device):
        rows = _Lookup.apply(table, flat)
    else:
        rows = table.index_select(0, flat)
    return rows.reshape(*ids.shape, table.shape[1])


def local_lookups(tables: list, ids_list: list) -> list:
    """Rows of each (table, ids) pair of tensors this rank holds (an
    exchange's local gathers against its blocks), with the lookups'
    backwards: a same-shape group takes ``embedding_lookup_multi``'s
    batched one (K3 on CUDA at C >= 8), the rest ``_Lookup``'s (K6 under
    "segmat"), so a CUDA backward needs no ``index_add_`` and repeats bit
    for bit; on the CPU autograd's gather, as before."""
    out: list = [None] * len(tables)
    groups = collections.defaultdict(list)
    for pos, (t, i) in enumerate(zip(tables, ids_list)):
        groups[(tuple(t.shape), tuple(i.shape), i.dtype)].append(pos)
    for positions in groups.values():
        if len(positions) > 1 and _fused_active(tables[positions[0]].device):
            rows = embedding_lookup_multi([tables[p] for p in positions],
                                          [ids_list[p] for p in positions])
        else:
            rows = [_local_lookup(tables[p], ids_list[p]) for p in positions]
        for p, r in zip(positions, rows):
            out[p] = r
    return out


class _LookupMulti(torch.autograd.Function):
    """Same-shape tables, one (N,) id vector each; the reference's
    ``_lookup_multi`` custom_vjp with its batched-sort backward."""

    @staticmethod
    def forward(ctx, ids_mat, *tables):
        ctx.save_for_backward(ids_mat)
        ctx.shape = tuple(tables[0].shape)
        ctx.segmat = _segmat_multi_active(ctx.shape[1], ids_mat.device)
        return tuple(t.index_select(0, i) for t, i in zip(tables, ids_mat))

    @staticmethod
    def backward(ctx, *gs):
        (ids_mat,) = ctx.saved_tensors
        vocab_size, k = ctx.shape
        t, n = ids_mat.shape
        sids, order = _sorted_order(ids_mat)  # one batched sort, (T, N)
        if ctx.segmat:
            # permute straight into K3's transposed (T, k, N) layout
            g_t = torch.stack(gs).transpose(1, 2)
            sg_t = torch.gather(g_t, 2, order[:, None, :].expand(t, k, n)).contiguous()
            grads = segment_matmul_from_sorted_batched(sids, sg_t, vocab_size)  # (T, k, V)
            return (None, *grads.transpose(1, 2).unbind(0))
        return (None, *(
            _scatter_sorted_rows(sids[i], g.index_select(0, order[i]), vocab_size)
            for i, g in enumerate(gs)
        ))


def embedding_lookup_multi(tables: list, ids_list: list) -> list:
    """Same-shape multi-table lookup with the batched-sort backward. All
    tables share one shape and all ids one shape."""
    flat = [i.reshape(-1) for i in ids_list]
    if _fused_active(tables[0].device) and len(tables) > 1:
        rows = _LookupMulti.apply(torch.stack(flat), *tables)
    else:
        rows = [t.index_select(0, i) for t, i in zip(tables, flat)]
    k = tables[0].shape[1]
    return [r.reshape(*i.shape, k) for r, i in zip(rows, ids_list)]


def embedding_lookup_grouped(tables, ids_list) -> list:
    """Lookups across tables -> list of row tensors. Same-shape subsets
    share the batched-sort backward (``embedding_lookup_multi``); the rest,
    and every ``QuantTable``, go per table (reference :1178-1210). Under
    an exchange the row-sharded ones share one exchange per tag."""
    assert len(tables) == len(ids_list)
    out: list = [None] * len(tables)
    by_shape = collections.defaultdict(list)
    by_tag = collections.defaultdict(list)
    for pos, (t, i) in enumerate(zip(tables, ids_list)):
        tag = _exchanged(t)
        if tag is not None:
            by_tag[tag].append(pos)
        else:
            by_shape[(tuple(t.shape), tuple(i.shape))].append(pos)
    for tag, positions in by_tag.items():
        rows = exchange_lookup([tables[p] for p in positions],
                               [ids_list[p] for p in positions], tag)
        for p, r in zip(positions, rows):
            out[p] = r
    for positions in by_shape.values():
        first = tables[positions[0]]
        if (len(positions) == 1 or isinstance(first, QuantTable)
                or not _fused_active(first.device)):
            for p in positions:
                out[p] = embedding_lookup(tables[p], ids_list[p])
        else:
            rows = embedding_lookup_multi([tables[p] for p in positions],
                                          [ids_list[p] for p in positions])
            for p, r in zip(positions, rows):
                out[p] = r
    return out


def _stacked_flat_ids(ids_mat, v: int):
    """(T, N) per-table ids -> row indices into a (T*V, ...) stack."""
    t = ids_mat.shape[0]
    return (ids_mat.long() + v * torch.arange(t, device=ids_mat.device)[:, None]).reshape(-1)


def _stacked_packed_grad(ids_mat, grad, v: int, segmat: bool):
    """The (T, V, C) grad of stacked packed rows from their (T, N, C)
    cotangents: one batched sort, then one K3 launch, the cotangents
    permuted straight into its transposed (T, C, V) layout and its output
    returned as a (T, V, C) view, or per-table ``index_add_``."""
    t, n, c = grad.shape
    sids, order = _sorted_order(ids_mat)
    if segmat:
        sg_t = torch.gather(grad.transpose(1, 2), 2, order[:, None, :].expand(t, c, n))
        grads = segment_matmul_from_sorted_batched(sids.contiguous(), sg_t.contiguous(), v)
        return grads.transpose(1, 2)
    return torch.stack([
        _scatter_sorted_rows(sids[i], grad[i].index_select(0, order[i]), v) for i in range(t)
    ])


class _StackedGatherSplit(torch.autograd.Function):
    """Per-table [stack[i] | w_cols[i]] rows; the reference's
    ``_stacked_gather_split`` custom_vjp (:970-1021)."""

    @staticmethod
    def forward(ctx, stack, w_cols, ids_mat):
        t, v, k = stack.shape
        flat = _stacked_flat_ids(ids_mat, v)
        rows = torch.cat([
            stack.reshape(t * v, k).index_select(0, flat),
            w_cols.reshape(t * v).index_select(0, flat)[:, None],
        ], dim=1)  # (T*N, k+1): the rows a [table | w] concat-then-gather gives
        ctx.save_for_backward(ids_mat)
        ctx.shape = (t, v, k)
        ctx.segmat = _segmat_multi_active(k + 1, ids_mat.device)
        return rows.reshape(t, ids_mat.shape[1], k + 1)

    @staticmethod
    def backward(ctx, grad):
        (ids_mat,) = ctx.saved_tensors
        _, v, k = ctx.shape
        d_packed = _stacked_packed_grad(ids_mat, grad, v, ctx.segmat)  # (T, V, k + 1)
        return d_packed[:, :, :k], d_packed[:, :, k], None


def packed_lookup_stacked_split(stack, w_cols, ids_list) -> list:
    """Stacked-storage packed lookup: ``stack`` (T, V, k), ``w_cols`` (T, V)
    linear-weight columns, ``ids_list`` T (N,) id vectors -> T (N, k+1)
    packed rows. The backward reaches the stack and the w columns through
    one sort, one permute and one K3 launch (or per-table scatters, by
    ``_segmat_multi_active``)."""
    ids_mat = torch.stack([i.reshape(-1) for i in ids_list])
    return list(_StackedGatherSplit.apply(stack, w_cols, ids_mat).unbind(0))


class _StackedGather(torch.autograd.Function):
    """Per-table rows of one (T, V, C) packed stack; the reference's
    ``_stacked_gather`` custom_vjp (:904-956). The backward is
    ``_StackedGatherSplit``'s, and its (T, V, C) grad reaches the stack
    unsplit."""

    @staticmethod
    def forward(ctx, packed, ids_mat):
        t, v, c = packed.shape
        rows = packed.reshape(t * v, c).index_select(0, _stacked_flat_ids(ids_mat, v))
        ctx.save_for_backward(ids_mat)
        ctx.v = v
        ctx.segmat = _segmat_multi_active(c, ids_mat.device)
        return rows.reshape(t, ids_mat.shape[1], c)

    @staticmethod
    def backward(ctx, grad):
        (ids_mat,) = ctx.saved_tensors
        return _stacked_packed_grad(ids_mat, grad, ctx.v, ctx.segmat), None


def packed_lookup_stacked(packed, ids_list) -> list:
    """Stacked-storage packed lookup from one (T, V, C) packed stack (the
    one-concat form, ``STACKED_SPLIT_CONCAT = False``): T (N, C) row
    tensors, one batched sort / permute / K3 backward."""
    ids_mat = torch.stack([i.reshape(-1) for i in ids_list])
    return list(_StackedGather.apply(packed, ids_mat).unbind(0))


class _LookupMultiSplit(torch.autograd.Function):
    """Same-shape tables and their vector columns gathered apart, giving the
    (N, k + n_vec) rows a [table | vec...] concat-then-gather would; the
    reference's ``_lookup_multi_split`` custom_vjp (:1037-1130). The
    backward sorts once, permutes the packed cotangents into (T, k_eff, N)
    and then, by the route read in the forward: K7 ("vk": the table grads
    row-major), K3 ("segmat": the table grads as (V, k) views of its (k, V)
    rows, the vector grads free row slices), or per-table ``index_add_`` of
    the packed rows ("scatter")."""

    @staticmethod
    def forward(ctx, ids_mat, n_tables, n_vec, *tensors):
        tables, vecs = tensors[:n_tables], tensors[n_tables:]
        v, k = tables[0].shape
        n = ids_mat.shape[1]
        rows = []
        for i, (table, ids) in enumerate(zip(tables, ids_mat)):
            parts = [table.index_select(0, ids)]
            parts += [vec.index_select(0, ids)[:, None] for vec in vecs[i * n_vec:(i + 1) * n_vec]]
            rows.append(torch.cat(parts, dim=1))
        ctx.save_for_backward(ids_mat)
        ctx.shape = (n_tables, v, k, n_vec)
        if not _segmat_multi_active(k + n_vec, ids_mat.device):
            ctx.route = "scatter"
        elif SEGMAT_VK_OUT and n <= SEGMAT_SEGMENT_N:
            ctx.route = "vk"
        else:
            ctx.route = "segmat"
        return tuple(rows)

    @staticmethod
    def backward(ctx, *gs):
        (ids_mat,) = ctx.saved_tensors
        t, v, k, n_vec = ctx.shape
        k_eff = k + n_vec
        n = ids_mat.shape[1]
        sids, order = _sorted_order(ids_mat)
        if ctx.route == "scatter":
            packed = [_scatter_sorted_rows(sids[i], g.index_select(0, order[i]), v)
                      for i, g in enumerate(gs)]  # (V, k_eff) each
            table_grads = [g[:, :k] for g in packed]
            vec_grads = [g[:, k + j] for g in packed for j in range(n_vec)]
            return (None, None, None, *table_grads, *vec_grads)
        g_t = torch.stack(gs).transpose(1, 2)  # (T, k_eff, N)
        sg_t = torch.gather(g_t, 2, order[:, None, :].expand(t, k_eff, n)).contiguous()
        sids = sids.contiguous()
        if ctx.route == "vk":
            emb, vec = segment_matmul_from_sorted_batched_vk(sids, sg_t, v, k, n_vec)
            table_grads = list(emb.unbind(0))
            vec_grads = [vec[i, j] for i in range(t) for j in range(n_vec)]
        else:
            grads = segment_matmul_from_sorted_batched(sids, sg_t, v)  # (T, k_eff, V)
            table_grads = [grads[i, :k].t() for i in range(t)]
            vec_grads = [grads[i, k + j] for i in range(t) for j in range(n_vec)]
        return (None, None, None, *table_grads, *vec_grads)


def packed_lookup_grouped(tables: list, vecs: list, ids_list: list) -> list:
    """Packed [table | vec...] rows across features without building the
    per-feature packed matrices (reference :1133-1175).

    ``tables``: per-feature (V, k) tables; ``vecs``: per-feature tuples of
    (V,) vector columns (bias and/or the linear w slice, the same number
    for every feature); ``ids_list``: per-feature ids (any shape). Returns
    per-feature (*ids.shape, k + n_vec) rows, as a concat-then-gather
    gives them. Same-shape groups share one ``_LookupMultiSplit``;
    singletons, and every feature when the fused backward is off, fall
    back to the concat and ``embedding_lookup``."""
    assert len(tables) == len(vecs) == len(ids_list)

    def concat_fallback(p):
        packed = torch.cat([tables[p]] + [v[:, None] for v in vecs[p]], dim=1)
        return embedding_lookup(packed, ids_list[p])

    by_shape = collections.defaultdict(list)
    for pos, (t, i) in enumerate(zip(tables, ids_list)):
        by_shape[(tuple(t.shape), tuple(i.shape), len(vecs[pos]))].append(pos)
    out: list = [None] * len(tables)
    for positions in by_shape.values():
        if len(positions) == 1 or not _fused_active(tables[positions[0]].device):
            for p in positions:
                out[p] = concat_fallback(p)
            continue
        n_vec = len(vecs[positions[0]])
        ids_mat = torch.stack([ids_list[p].reshape(-1) for p in positions])
        rows = _LookupMultiSplit.apply(
            ids_mat, len(positions), n_vec, *(tables[p] for p in positions),
            *(v for p in positions for v in vecs[p]))
        k_eff = tables[positions[0]].shape[1] + n_vec
        for p, r in zip(positions, rows):
            out[p] = r.reshape(*ids_list[p].shape, k_eff)
    return out
