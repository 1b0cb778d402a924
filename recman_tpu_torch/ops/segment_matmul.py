"""Sorted segment sums: the dense table gradients of the embedding lookups.

K3, batched over same-shape tables, transposed output. Counterpart of ``_segment_matmul_from_sorted_batched`` in
``recman_tpu/ops/embedding.py`` (:405-524): sorted ids (T, N) and the
cotangents permuted into that order, transposed to (T, C, N), give the
transposed dense grads (T, C, V): column v of table t is the f32 sum of
the cotangents whose id is v, 0 where no id falls. Ids outside [0, V)
land nowhere, as the reference's padding ids do.

``segment_matmul_from_sorted_batched`` launches kernel K3
(``csrc/segment_matmul.cu``) on a CUDA tensor and runs the plain PyTorch
version ``segment_matmul_reference`` on a CPU tensor. The reference's
``SEGMAT_SEGMENT_N`` segmenting (:792-821) is a TPU VMEM workaround and
is not ported: one call takes any N.

K3 on the card is four launches on the current stream, counted as one
call, each after the first launched as a programmatic dependent of the
one before, so that it starts while that one drains: a clear of the map
from ids to records; the sums, partitioned by sorted position so that
Zipf-skewed ids give every warp the same work (a warp owns one table,
128 consecutive positions and 4 rows, and sums each run by a segmented
scan in a fixed order) into records, with each run's record slot in the
map; a fix-up that sums the runs which cross those chunks, in chunk
order; and a pass that writes every output element once, in 16-byte
stores, as its record or 0 (the zeros are most of the bytes). The map,
the records and the chunks' partials go to a scratch that the wrapper
allocates with ``torch.empty`` (``segment_matmul_scratch_floats`` of the
library: T * V words for the map and about one float a position and row;
25 MB at the training geometry, 127 MB at N 65,536). No atomics: two
calls give the same bits.

K6, one table, row-major output. Counterpart of
``_segment_matmul_from_sorted`` (:323-389), the kernel of a single
lookup's backward under ``grad_kernel("segmat")``: sorted ids (N,) and the
cotangent rows permuted into that order, (N, C), give the dense grad
(V, C), row-major as the reference writes it.
``segment_matmul_from_sorted`` launches K6 (``csrc/segment_matmul.cu``,
beside K3) on a CUDA tensor and runs ``segment_matmul_rows_reference`` on
a CPU tensor. K6 runs K3's sums, reading the (N, C) rows in place, and
its fix-up on the one table, so its sums are K7's bits at T = 1 on the
transposed cotangents, in one cooperative launch: the sums and zeros over
the output, a grid-wide barrier, the fix-up, a barrier, then each run's
sums copied to its id's row. Four launches cost the host more than the
passes take on the card at K6's shapes. Its scratch is K3's at T = 1 and
the records' ids (``segment_matmul_rows_scratch_floats``).

K7, batched, row-major table output. Counterpart of
``_segment_matmul_from_sorted_batched_vk`` (:609-723), the kernel of the
split packed lookup's backward under ``SEGMAT_VK_OUT``: K3's inputs, with
the cotangent rows split into k_emb table rows and n_vec vector rows,
give the table grads (T, V, k_emb) row-major and the vector grads (T,
n_vec, V). ``segment_matmul_from_sorted_batched_vk`` launches K7
(``csrc/segment_matmul.cu``) on a CUDA tensor and runs
``segment_matmul_vk_reference`` on a CPU tensor. K7 runs K3's passes,
with another layout in the last, so its sums are K3's bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load

# Launches of K3, K6 and K7, each counted where its wrapper launches it
# (and nowhere else); callers reset them to 0 to count one run's launches.
LAUNCHES = 0
ROWS_LAUNCHES = 0
VK_LAUNCHES = 0


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


def _entry(name, restype, argtypes):
    """The library's C function ``name``, with its types."""
    fn = getattr(load("segment_matmul"), name)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


def _stream(tensor):
    """The raw handle of PyTorch's current stream on the CUDA tensor's
    device, without the Stream object that
    ``torch.cuda.current_stream(device).cuda_stream`` builds first: K6's
    calls are bound by the host."""
    return torch._C._cuda_getCurrentRawStream(tensor.get_device())


# Each C entry is bound once, at its first call.
@functools.cache
def _k3():
    return _entry("segment_matmul_sorted_batched", ctypes.c_int,
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.cache
def _scratch_floats():
    return _entry("segment_matmul_scratch_floats", ctypes.c_longlong, [ctypes.c_int] * 4)


@functools.cache
def _rows_scratch_floats():
    return _entry("segment_matmul_rows_scratch_floats", ctypes.c_longlong, [ctypes.c_int] * 3)


def _scratch(t, c, n, v, device):
    """The passes' scratch: the records of the runs, the chunks' partials
    and the map from ids to records."""
    return torch.empty(_scratch_floats()(t, c, n, v), dtype=torch.float32, device=device)


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
    if not 1 <= t * c <= 65535 or min(n, vocab_size) < 1 or t * c * vocab_size >= 2**62:
        raise ValueError(f"K3 takes 1 <= T * C <= 65535 (the write pass's lines) and nonempty "
                         f"N, V; got T={t}, C={c}, N={n}, V={vocab_size}")
    out = torch.empty((t, c, vocab_size), dtype=torch.float32, device=sg_t.device)
    scratch = _scratch(t, c, n, vocab_size, sg_t.device)
    stream = _stream(sg_t)
    err = _k3()(sids.data_ptr(), sg_t.data_ptr(), out.data_ptr(), scratch.data_ptr(), t, c, n,
                vocab_size, stream)
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


def segment_matmul_rows_reference(sids, sg, vocab_size: int):
    """Plain PyTorch version of K6 (the CPU path and K6's oracle): K3's
    prefix-sum twin on the one table, transposed back to rows."""
    out_t = segment_matmul_reference(sids[None], sg.t()[None], vocab_size)  # (1, C, V)
    return out_t[0].t().contiguous()


@functools.cache
def _k6():
    return _entry("segment_matmul_sorted_rows", ctypes.c_int,
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _segment_matmul_rows_cuda(sids, sg, vocab_size):
    global ROWS_LAUNCHES
    if sids.dtype != torch.int32 or sids.dim() != 1 or not sids.is_contiguous():
        raise ValueError("K6 takes sids as a contiguous (N,) int32 tensor")
    if sg.dtype != torch.float32 or sg.dim() != 2 or not sg.is_contiguous():
        raise ValueError("K6 takes the cotangents as a contiguous (N, C) float32 tensor")
    n, c = sg.shape
    if sids.shape[0] != n or sids.get_device() != sg.get_device():
        raise ValueError(f"K6: sids {tuple(sids.shape)} on {sids.device} do not match "
                         f"cotangents {tuple(sg.shape)} on {sg.device}")
    if min(n, c, vocab_size) < 1:
        raise ValueError(f"K6 takes nonempty N, C and V; got N={n}, C={c}, V={vocab_size}")
    out = torch.empty((vocab_size, c), dtype=torch.float32, device=sg.device)
    scratch = torch.empty(_rows_scratch_floats()(c, n, vocab_size), dtype=torch.float32,
                          device=sg.device)
    err = _k6()(sids.data_ptr(), sg.data_ptr(), out.data_ptr(), scratch.data_ptr(), c, n,
                vocab_size, _stream(sg))
    if err != 0:
        raise RuntimeError(f"K6 (segment_matmul_rows) launch failed: CUDA error {err}")
    ROWS_LAUNCHES += 1
    return out


def segment_matmul_from_sorted(sids, sg, vocab_size: int):
    """(N,) sorted ids + (N, C) permuted cotangents -> (V, C) dense grad.
    Launches K6 for a CUDA tensor (raising on what it does not take) and
    runs the plain version for a CPU tensor."""
    if sg.is_cuda:
        return _segment_matmul_rows_cuda(sids, sg, vocab_size)
    if sg.device.type == "cpu":
        return segment_matmul_rows_reference(sids, sg, vocab_size)
    raise ValueError(f"segment_matmul_from_sorted: no path for device {sg.device}")


def segment_matmul_vk_reference(sids, sg_t, vocab_size: int, k_emb: int, n_vec: int):
    """Plain PyTorch version of K7 (the CPU path and K7's oracle): K3's
    prefix-sum twin, its first k_emb rows transposed to row-major."""
    out = segment_matmul_reference(sids, sg_t, vocab_size)  # (T, k_emb + n_vec, V)
    return out[:, :k_emb].transpose(1, 2).contiguous(), out[:, k_emb:].contiguous()


@functools.cache
def _k7():
    return _entry("segment_matmul_sorted_batched_vk", ctypes.c_int,
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _segment_matmul_vk_cuda(sids, sg_t, vocab_size, k_emb, n_vec):
    global VK_LAUNCHES
    if sids.dtype != torch.int32 or sids.dim() != 2 or not sids.is_contiguous():
        raise ValueError("K7 takes sids as a contiguous (T, N) int32 tensor")
    if sg_t.dtype != torch.float32 or sg_t.dim() != 3 or not sg_t.is_contiguous():
        raise ValueError("K7 takes the cotangents as a contiguous (T, C, N) float32 tensor")
    t, c, n = sg_t.shape
    if tuple(sids.shape) != (t, n) or sids.device != sg_t.device:
        raise ValueError(f"K7: sids {tuple(sids.shape)} on {sids.device} do not match "
                         f"cotangents {tuple(sg_t.shape)} on {sg_t.device}")
    if k_emb < 1 or n_vec < 0 or c != k_emb + n_vec:
        raise ValueError(f"K7 takes 1 <= k_emb, 0 <= n_vec, k_emb + n_vec = C; got "
                         f"k_emb={k_emb}, n_vec={n_vec}, C={c}")
    if (not 1 <= t * max(n_vec, 1) <= 65535 or c > 262_140 or t * c > 2**24
            or vocab_size * k_emb > 2**30 or min(n, vocab_size) < 1):
        raise ValueError(f"K7 takes 1 <= T * max(n_vec, 1) <= 65535 (the write pass's lines), "
                         f"C <= 262,140, T * C <= 2**24 (the sums' grid), V * k_emb <= 2**30 "
                         f"and nonempty N, V; got T={t}, C={c}, N={n}, V={vocab_size}")
    emb = torch.empty((t, vocab_size, k_emb), dtype=torch.float32, device=sg_t.device)
    vec = torch.empty((t, n_vec, vocab_size), dtype=torch.float32, device=sg_t.device)
    scratch = _scratch(t, c, n, vocab_size, sg_t.device)
    stream = _stream(sg_t)
    err = _k7()(sids.data_ptr(), sg_t.data_ptr(), emb.data_ptr(),
                vec.data_ptr() if n_vec else None, scratch.data_ptr(), t, k_emb, n_vec, n,
                vocab_size, stream)
    if err != 0:
        raise RuntimeError(f"K7 (segment_matmul_vk) launch failed: CUDA error {err}")
    VK_LAUNCHES += 1
    return emb, vec


def segment_matmul_from_sorted_batched_vk(sids, sg_t, vocab_size: int, k_emb: int,
                                          n_vec: int):
    """(T, N) sorted ids + (T, k_emb + n_vec, N) permuted cotangents ->
    ((T, V, k_emb) table grads, (T, n_vec, V) vector grads). Launches K7
    for a CUDA tensor (raising on what it does not take) and runs the plain
    version for a CPU tensor."""
    if sg_t.is_cuda:
        return _segment_matmul_vk_cuda(sids, sg_t, vocab_size, k_emb, n_vec)
    if sg_t.device.type == "cpu":
        return segment_matmul_vk_reference(sids, sg_t, vocab_size, k_emb, n_vec)
    raise ValueError(f"segment_matmul_from_sorted_batched_vk: no path for device {sg_t.device}")
