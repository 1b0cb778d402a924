"""Batched sorted segment sum: the dense table gradient of the stacked
embedding lookup.

Counterpart of ``_segment_matmul_from_sorted_batched`` in
``recman_tpu/ops/embedding.py`` (:405-524): sorted ids (T, N) and the
cotangents permuted into that order, transposed to (T, C, N), give the
transposed dense grads (T, C, V): column v of table t is the f32 sum of
the cotangents whose id is v, 0 where no id falls. Ids outside [0, V)
land nowhere, as the reference's padding ids do.

``segment_matmul_from_sorted_batched`` launches kernel K3
(``csrc/segment_matmul.cu``) on a CUDA tensor and runs the plain PyTorch
version ``segment_matmul_reference`` on a CPU tensor. The reference's
``SEGMAT_SEGMENT_N`` segmenting (:792-821) is a TPU VMEM workaround and
is not ported: one launch takes any N.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import load

# Launches of K3, counted where the wrapper launches it (and nowhere
# else); callers reset it to 0 to count the launches of one run.
LAUNCHES = 0


def segment_matmul_reference(sids, sg_t, vocab_size: int):
    """Plain PyTorch version of K3 (the CPU path and K3's oracle).

    Sums each run of equal sorted ids as a difference of float64 prefix
    sums, so every column is the f32 rounding of its sum, whatever order
    a kernel adds in; the rounding to f32 comes last.
    """
    t, c, n = sg_t.shape
    out = torch.zeros((t, c, vocab_size), dtype=sg_t.dtype, device=sg_t.device)
    if n == 0:
        return out
    sids = sids.long()
    first = torch.ones((t, n), dtype=torch.bool, device=sids.device)
    first[:, 1:] = sids[:, 1:] != sids[:, :-1]
    last = torch.ones_like(first)
    last[:, :-1] = first[:, 1:]
    csum = torch.cumsum(sg_t.double(), dim=2)  # (T, C, N)
    t_end, p_end = last.nonzero(as_tuple=True)
    _, p_start = first.nonzero(as_tuple=True)  # same runs, same order
    before = csum[t_end, :, (p_start - 1).clamp_min(0)]
    before = torch.where((p_start > 0)[:, None], before, 0.0)
    sums = csum[t_end, :, p_end] - before  # (runs, C)
    ids = sids[t_end, p_end]
    keep = (ids >= 0) & (ids < vocab_size)
    out[t_end[keep], :, ids[keep]] = sums[keep].to(sg_t.dtype)
    return out


def _k3():
    fn = load("segment_matmul").segment_matmul_sorted_batched
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _segment_matmul_cuda(sids, sg_t, vocab_size):
    global LAUNCHES
    if sids.dtype != torch.int32 or sids.dim() != 2 or not sids.is_contiguous():
        raise ValueError("K3 takes sids as a contiguous (T, N) int32 tensor")
    if sg_t.dtype != torch.float32 or sg_t.dim() != 3 or not sg_t.is_contiguous():
        raise ValueError("K3 takes the cotangents as a contiguous (T, C, N) float32 tensor")
    t, c, n = sg_t.shape
    if tuple(sids.shape) != (t, n) or sids.device != sg_t.device:
        raise ValueError(f"K3: sids {tuple(sids.shape)} on {sids.device} do not match "
                         f"cotangents {tuple(sg_t.shape)} on {sg_t.device}")
    if not 1 <= t <= 65535 or min(c, n, vocab_size) < 1 or t * c * vocab_size >= 2**62:
        raise ValueError(f"K3 takes 1 <= T <= 65535 and nonempty C, N, V; got "
                         f"T={t}, C={c}, N={n}, V={vocab_size}")
    out = torch.empty((t, c, vocab_size), dtype=torch.float32, device=sg_t.device)
    stream = torch.cuda.current_stream(sg_t.device).cuda_stream
    err = _k3()(sids.data_ptr(), sg_t.data_ptr(), out.data_ptr(), t, c, n, vocab_size, stream)
    if err != 0:
        raise RuntimeError(f"K3 (segment_matmul) launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def segment_matmul_from_sorted_batched(sids, sg_t, vocab_size: int):
    """(T, N) sorted ids + (T, C, N) permuted cotangents -> (T, C, V) dense
    grads. Launches K3 for a CUDA tensor (raising on what it does not
    take) and runs the plain version for a CPU tensor."""
    if sg_t.is_cuda:
        return _segment_matmul_cuda(sids, sg_t, vocab_size)
    if sg_t.device.type == "cpu":
        return segment_matmul_reference(sids, sg_t, vocab_size)
    raise ValueError(f"segment_matmul_from_sorted_batched: no path for device {sg_t.device}")
