"""Lookups against row-sharded embedding tables: the two exchanges.

Counterpart of ``recman_tpu/parallel/shard_lookup.py``. Each rank holds one
contiguous block of a table's rows (rank m of the model group rows
``[m * rows_per, (m + 1) * rows_per)``) and the ids of its data shard,
replicated over the model group, as the reference's ``in_specs`` say:

1. ``sharded_embedding_lookup`` — masked gather + all-reduce. Each model
   rank gathers the rows it owns (ids outside its block masked to zero)
   and one all-reduce over ``model`` assembles full rows everywhere. Its
   backward passes the cotangent through, masked by ownership, to the
   local block (``collectives.all_reduce``), whose gathers take the
   lookups' backwards (``ops.embedding.local_lookups``: K3 for the
   embedding tower's same-shape blocks on CUDA), so it repeats bit for
   bit there.

2. ``dedup_embedding_lookup`` — sort + run-length dedup +
   capacity-bounded all-gather (the DLRM-style exchange, ``_dedup_exchange``
   below, steps a-e): one sort of the ids with their positions; run-length
   dedup; the owner and the rank within its owner of each unique; each
   rank's owned uniques (at most ``capacity``) in a ``(capacity, k)``
   buffer; one all-gather over ``model``; every position reads its row at
   (owner, rank) and the unsort restores input order. Its backward is a
   reduce-scatter of the buffers' cotangents (``collectives.all_gather``),
   then the local gather's. Rows past the capacity come back as zeros and
   are counted (``check_overflow``).

Gradients reach only the local block; the train step then sums table
blocks over the data group. The sort, the dedup and the gathers are a few
PyTorch index ops each, as the reference writes them in jnp outside any
Pallas call; the dedup exchange's backward takes autograd's gathers
(``index_add_`` on CUDA, whose float sums may come out in another order
from one run to the next).

Both take a list of tables in one call (``_psum_rows``, ``_dedup_rows``):
the embedding tower's same-shape tables then share one collective, with the
same bytes as one call each.
"""

from __future__ import annotations

import numpy as np
import torch

from .collectives import all_gather, all_reduce
from .mesh import DATA_AXIS, MODEL_AXIS


def _psum_rows(tables, ids_list, mesh, tag="table") -> list:
    """Rows of each (block, ids) pair: masked local gathers
    (``ops.embedding.local_lookups``), one all-reduce over the model axis
    for all of them."""
    from ..ops.embedding import local_lookups

    my = mesh.model_index
    rels, hits = [], []
    for table, ids in zip(tables, ids_list):
        rows_per = table.shape[0]
        rel = ids.reshape(-1).long() - my * rows_per
        hits.append((rel >= 0) & (rel < rows_per))
        rels.append(rel.clamp(0, rows_per - 1))
    parts = [rows * hit[:, None].to(rows.dtype)
             for rows, hit in zip(local_lookups(tables, rels), hits)]
    flat = all_reduce(torch.cat([p.reshape(-1) for p in parts]), mesh, MODEL_AXIS, tag)
    out, start = [], 0
    for p, ids in zip(parts, ids_list):
        out.append(flat[start: start + p.numel()].reshape(*ids.shape, p.shape[1]))
        start += p.numel()
    return out


def sharded_embedding_lookup(table, ids, mesh):
    """Masked-gather + all-reduce exchange (the reference's
    partitioner-equivalent baseline). ``table``: this rank's (V / S, k)
    block of a (V, k) table row-sharded over the model axis (V divides S:
    ``sharding.pad_vocab_for_mesh``); ``ids``: this rank's ids, any shape,
    in [0, V). Returns ids.shape + (k,) rows."""
    return _psum_rows([table], [ids], mesh)[0]


def default_capacity(n: int, n_shards: int, factor: float = 4.0) -> int:
    """Static per-shard unique-row bound: ceil(factor * N / S), clamped to N.

    factor=4.0 is a SAFETY default justified by measurement
    (tools/traffic_accounting.py, 2026-08-20): Zipf-RANKED id streams
    concentrate uniques up to 4.7x on one shard at S=8 (worst-table
    max-owned 1426 vs 4N/S=4096 at N=8192 — 2.9x headroom). It is NOT a
    traffic-optimal default: dedup beats psum only when capacity < N/S
    (the capacity factor IS the dedup:psum traffic ratio —
    parallel/traffic.py), which needs hashed/permuted row assignment
    plus a measured capacity ~1.5x the sample's max per-shard uniques
    (0.51·N/S measured for hashed streams). Pass ``dedup_capacity``
    from a measured sample for the win; the overflow guard catches
    underestimates. ``capacity_from_sample`` computes exactly that.
    """
    return min(n, -(-int(factor * n) // n_shards))


def capacity_from_sample(ids_by_table, n_shards: int, vocab: int,
                         safety: float = 1.5) -> int:
    """Data-driven dedup capacity from a HOST batch sample.

    The dedup:psum traffic ratio IS capacity*S/N (parallel/traffic.py),
    so a measured capacity — ``safety`` x the worst per-shard unique-row
    count over the sampled tables — is what actually realizes the
    exchange's bandwidth win (the 4N/S default is a 2.9x-headroom safety
    bound for ranked vocabularies; ~12x oversized for hashed ones —
    measured numbers in docs/sharding_guide.md). Use a sample with the
    PRODUCTION per-data-shard batch size; the runtime overflow guard
    catches under-estimates rather than corrupting training.

    ``ids_by_table``: iterable of 1-D id arrays (one per sharded table).
    """
    from .sharding import pad_vocab_for_mesh

    # mirror the exchange's row ownership exactly: the exchange divides the
    # mesh-PADDED vocab (place_params pads tables to a multiple of S), so
    # sampling with the raw vocab would shift attribution near shard edges
    # and can under-size capacity
    rows_per = pad_vocab_for_mesh(vocab, n_shards) // n_shards
    worst = 1
    for ids in ids_by_table:
        uniq = np.unique(np.asarray(ids).reshape(-1))
        owned = np.bincount(
            np.clip(uniq // rows_per, 0, n_shards - 1), minlength=n_shards
        )
        worst = max(worst, int(owned.max()))
    return int(np.ceil(worst * float(safety)))


def _dedup_exchange(table, ids, *, my, n_shards, capacity):
    """Steps a-c and the fetch plan of e for one table block: returns this
    rank's (capacity, k) buffer of owned unique rows, the plan and the
    overflow count (the model group's: every model rank computes the same
    ownership from the same ids)."""
    rows_per = table.shape[0]
    n = ids.shape[0]
    dev = ids.device
    # a. one sort, shared by every step below
    sids, order = torch.sort(ids.to(torch.int64), stable=True)
    # b. run-length dedup in sorted order
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sids[1:] != sids[:-1]
    uslot = torch.cumsum(first, 0) - 1  # sorted pos -> unique slot
    n_unique = uslot[-1] + 1
    # unique ids, compacted to the front of a length-N buffer
    uids = torch.zeros(n, dtype=torch.int64, device=dev).scatter_(0, uslot, sids)
    # owner of each unique slot and its rank within that owner's uniques
    owner = (uids // rows_per).clamp(0, n_shards - 1)
    iota = torch.arange(n, device=dev)
    valid = iota < n_unique
    # uids ascend where valid, so equal owners are contiguous
    owner_start = torch.searchsorted(torch.where(valid, owner, n_shards),
                                     torch.arange(n_shards, device=dev), side="left")
    rank = iota - owner_start[owner]
    # c. this rank gathers its owned uniques into a (capacity, k) buffer
    mine = valid & (owner == my) & (rank < capacity)
    local_row = torch.where(mine, uids - my * rows_per, 0)
    rows = table.index_select(0, local_row) * mine[:, None].to(table.dtype)
    slot = torch.where(mine, rank, capacity)  # capacity = the dropped row
    buf = torch.zeros((capacity + 1, table.shape[1]), dtype=table.dtype, device=dev)
    buf = buf.index_add(0, slot, rows)[:capacity]
    in_cap = rank < capacity
    fetch = owner * capacity + rank.clamp(0, capacity - 1)
    overflow = (valid & ~in_cap).sum()
    return buf, (fetch[uslot], in_cap[uslot], order), overflow


def _dedup_fetch(all_buf, plan):
    """e. per original position: (owner, rank) -> gathered row, then the
    unsort."""
    fetch, in_cap, order = plan
    sorted_rows = all_buf.index_select(0, fetch) * in_cap[:, None].to(all_buf.dtype)
    return torch.zeros_like(sorted_rows).index_copy(0, order, sorted_rows)


def _dedup_rows(tables, ids_list, mesh, capacity=None, tag="table"):
    """Rows of each (block, ids) pair through the dedup exchange, one
    all-gather over the model axis for all of them, and the model group's
    overflow count."""
    s = mesh.shape[MODEL_AXIS]
    my = mesh.model_index
    bufs, plans, caps, overflow = [], [], [], 0
    for table, ids in zip(tables, ids_list):
        flat = ids.reshape(-1)
        n = flat.shape[0]
        cap = min(capacity if capacity else default_capacity(n, s), n)
        buf, plan, over = _dedup_exchange(table, flat, my=my, n_shards=s, capacity=cap)
        bufs.append(buf)
        plans.append(plan)
        caps.append(cap)
        overflow = overflow + over
    # d. one all-gather: each unique row crosses the model axis once
    all_flat = all_gather(torch.cat([b.reshape(-1) for b in bufs]), mesh, MODEL_AXIS, tag)
    all_flat = all_flat.reshape(s, -1)
    out, start = [], 0
    for buf, plan, cap, ids in zip(bufs, plans, caps, ids_list):
        k = buf.shape[1]
        all_buf = all_flat[:, start: start + cap * k].reshape(s * cap, k)
        start += cap * k
        out.append(_dedup_fetch(all_buf, plan).reshape(*ids.shape, k))
    return out, overflow


def dedup_embedding_lookup(table, ids, mesh, capacity=None, shard_batch=True,
                           check_overflow=False):
    """Deduped all-to-all-style lookup against a row-sharded table.

    ``table``: this rank's (V / S, k) block; ``ids``: this rank's ids (its
    data shard's when ``shard_batch``, the whole batch on every rank
    otherwise), any shape, int IN [0, V) — mask PAD ids before calling, as
    the packed layer does. Returns ids.shape + (k,) rows, and with
    ``check_overflow`` the overflow count too (summed over the data group
    when ``shard_batch``). Exact whenever each model rank owns at most
    ``capacity`` of the ids' uniques (default ``default_capacity``);
    ``capacity=N`` is unconditionally exact."""
    rows, overflow = _dedup_rows([table], [ids], mesh, capacity)
    if not check_overflow:
        return rows[0]
    overflow = torch.as_tensor(overflow, device=rows[0].device)
    if shard_batch:
        overflow = all_reduce(overflow, mesh, DATA_AXIS, "overflow")
    return rows[0], overflow
