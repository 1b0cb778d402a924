"""Every collective of the port, over a named axis of a ``Mesh``.

The differentiable ones are ``torch.autograd.Function``s. Their backwards
follow from what the ranks of an axis compute, and there are two cases:

**Replicas of one objective** (the model axis). The ranks of one model
group compute the dense part of the model on identical rows, as replicas
of ONE objective, so the cotangent a rank holds for a replicated result is
already the whole one:

- ``all_reduce`` (a sum consumed by every rank): the backward passes the
  cotangent through: no collective, as the reference's psum transposes
  locally (``traffic.py``: psum_bwd = 0). In a tensor-parallel DNN this is
  Megatron's g, after a row-sharded layer;
- ``all_gather``: the backward is a ``reduce_scatter`` of the cotangents
  over the axis divided by its size: the mean of the replicas' cotangents
  for this rank's slice, which is that slice where they agree (JAX's
  transpose, a psum_scatter of the 1/S-scaled cotangents of an output
  replicated over the axis), at the bytes ``traffic.py`` counts for it;
- ``copy_to_blocks`` (Megatron's f, before a column-sharded layer): the
  identity forward; the backward sums the cotangents over the axis, since
  each rank's holds only its block's share of the input's;
- ``block_of``: this rank's block of a replicated tensor; the backward
  all-gathers the blocks' cotangents, so the replicated tensor's gradient
  is whole, and equal, on every rank of the axis.

**Ranks whose objectives are summed** (the data axis). Each data rank's
objective is its rows' share of the global loss, and the gradients are
summed over the data group afterwards. A value shared across the data
ranks (Dice's batch moments, DIEN's rolled negative) feeds every rank's
objective, so its cotangent is the SUM of the ranks' cotangents:

- ``all_reduce_summed``: the backward all-reduces the cotangent; passing
  it through (as ``all_reduce`` does) would drop the other ranks'
  dependence on the shared sum;
- ``all_gather_summed``: the backward reduce-scatters the cotangents with
  no division: each rank's block gets every rank's cotangent for it.

``TRAFFIC`` counts what every call moves, by (op, axis, tag), in the ring
model's bytes per rank (``traffic.py``): an all-reduce of SIZE bytes 2(S-1)/S
SIZE, an all-gather of OUT bytes (S-1)/S OUT, a reduce-scatter of IN bytes
(S-1)/S IN. A call over a one-rank axis moves nothing and is skipped.

The transport: NCCL for one rank per card; Gloo for two ranks on one card,
where NCCL refuses them ("Duplicate GPU detected"). On the card (torch
2.11) Gloo took CUDA tensors for every op used here (all_reduce,
all_gather_into_tensor, reduce_scatter_tensor; checked with both ranks on
cuda:0), so no op is staged through host memory: Gloo copies a CUDA
tensor to the host and back itself.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS

# (op, axis, tag) -> bytes per rank in the ring model
TRAFFIC: collections.Counter = collections.Counter()

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def reset_traffic():
    TRAFFIC.clear()


def traffic(op=None, axis=None, tag=None) -> float:
    """Bytes counted since the last reset, summed over the keys that match
    every given field."""
    return sum(b for (o, a, t), b in TRAFFIC.items()
               if (op is None or o == op) and (axis is None or a == axis)
               and (tag is None or t == tag))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _count(op, axis, tag, nbytes):
    TRAFFIC[(op, axis, tag)] += nbytes


def axis_size(mesh, axis) -> int:
    return len(mesh.ranks) if axis == "mesh" else mesh.shape[axis]


def _all_reduce(x, mesh, axis, tag, op="sum"):
    """A new tensor, the reduction of ``x`` over the axis."""
    s = axis_size(mesh, axis)
    out = x.clone()
    if s == 1:
        return out
    _count("all_reduce", axis, tag, 2 * (s - 1) * _nbytes(x) // s)
    dist.all_reduce(out, op=_REDUCE_OPS[op], group=mesh.group(axis))
    return out


def _all_gather(x, mesh, axis, tag):
    """(S * n, ...) from (n, ...): the axis' blocks in rank order."""
    s = axis_size(mesh, axis)
    x = x.contiguous()
    if s == 1:
        return x.clone()
    _count("all_gather", axis, tag, (s - 1) * _nbytes(x))
    out = torch.empty((s * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.group(axis))
    return out


def reduce_scatter(x, mesh, axis, tag=""):
    """(n, ...) from (S * n, ...): this rank's block of the sum over the
    axis."""
    s = axis_size(mesh, axis)
    x = x.contiguous()
    if s == 1:
        return x.clone()
    _count("reduce_scatter", axis, tag, (s - 1) * _nbytes(x) // s)
    out = torch.empty((x.shape[0] // s, *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=mesh.group(axis))
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag, summed):
        ctx.mesh, ctx.axis, ctx.tag, ctx.summed = mesh, axis, tag, summed
        return _all_reduce(x, mesh, axis, tag)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _all_reduce(g, ctx.mesh, ctx.axis, ctx.tag)
        return g, None, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag, summed):
        ctx.mesh, ctx.axis, ctx.tag, ctx.summed = mesh, axis, tag, summed
        return _all_gather(x, mesh, axis, tag)

    @staticmethod
    def backward(ctx, g):
        if not ctx.summed:
            g = g / axis_size(ctx.mesh, ctx.axis)
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.tag), None, None, None, None


class _CopyToBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        ctx.mesh, ctx.axis, ctx.tag = mesh, axis, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis, ctx.tag), None, None, None


class _BlockOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tag):
        ctx.mesh, ctx.axis, ctx.dim, ctx.tag = mesh, axis, dim, tag
        n = x.shape[dim] // axis_size(mesh, axis)
        i = mesh.data_index if axis == DATA_AXIS else mesh.model_index
        return x.narrow(dim, i * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        g = _all_gather(g.movedim(ctx.dim, 0), ctx.mesh, ctx.axis, ctx.tag)
        return g.movedim(0, ctx.dim), None, None, None, None


def all_reduce(x, mesh, axis, tag="", op="sum"):
    """The sum (or "max", "min") of ``x`` over the axis, on every rank of
    it. A sum is differentiable: its backward passes the cotangent
    through, for an axis of replicas (see the module docstring)."""
    if op == "sum":
        return _AllReduce.apply(x, mesh, axis, tag, False)
    return _all_reduce(x, mesh, axis, tag, op)


def all_reduce_summed(x, mesh, axis, tag=""):
    """The sum of ``x`` over an axis whose ranks' objectives are summed;
    its backward all-reduces the cotangent (see the module docstring)."""
    return _AllReduce.apply(x, mesh, axis, tag, True)


def all_gather(x, mesh, axis, tag=""):
    """The axis' ``x`` blocks concatenated along dim 0 in rank order, on
    every rank of it; differentiable (backward: ``reduce_scatter`` of the
    cotangent over S, for an axis of replicas)."""
    return _AllGather.apply(x, mesh, axis, tag, False)


def all_gather_summed(x, mesh, axis, tag=""):
    """``all_gather`` over an axis whose ranks' objectives are summed: its
    backward reduce-scatters the cotangents undivided."""
    return _AllGather.apply(x, mesh, axis, tag, True)


def copy_to_blocks(x, mesh, axis, tag=""):
    """``x`` as it is, for a consumer that each rank of the axis computes
    one block of (Megatron's f); the backward sums the cotangents over the
    axis."""
    return _CopyToBlocks.apply(x, mesh, axis, tag)


def block_of(x, mesh, axis, dim, tag=""):
    """This rank's block of a replicated ``x`` along ``dim`` (which must
    divide the axis); the backward all-gathers the blocks' cotangents."""
    return _BlockOf.apply(x, mesh, axis, dim, tag)


def gather_blocks(x, mesh, axis, dim, tag=""):
    """The axis' blocks of ``x`` concatenated along ``dim`` (a view of
    ``all_gather`` along another dim; its backward as ``all_gather``'s)."""
    if dim == 0:
        return all_gather(x, mesh, axis, tag)
    return all_gather(x.movedim(dim, 0), mesh, axis, tag).movedim(0, dim)
