"""Whole-chain CIN: every layer, bias, activation, direct-connect split and
pooling over the embedding dim in one forward call, and the whole tower's
backward in one more.

Counterpart of ``recman_tpu/ops/cin_chain.py``. Reference semantics
(recman/tf/core/layers.py:711-760), field-major, column n = b*D + d:

    pre[o, n] = sum_{h,m} x0[h, n] * xk[m, n] * W[h*Hk+m, o] + b[o]
    fmap      = act(pre)

The first half of a non-final fmap feeds the next layer; the rest (all of
the final fmap) is sum-pooled over D into batch-major (B, F_i) blocks.
z and W enter the products as bf16 and the sums run in f32, as in the
reference.

Kernels (sources in ``csrc/``, on the tensor cores: bf16 operands, f32
sums), each beside its plain PyTorch twin, which is the CPU path and the
kernel's oracle. The wrappers lay bf16(W) out once per call, Hk padded to
8 (``k1_weight_layouts``, ``k2_weight_layouts``), inside the launch:

- K1 ``csrc/cin_chain_fwd.cu`` (the TPU kernel ``_chain_fwd_kernel``):
  the forward. With ``save=True`` it also writes every layer's fmap
  (O_i, B*D) f32 for the backward (``CHAIN_SAVE_FMAPS`` in the
  reference); serving launches it without. K1 is the registered op
  ``recman_tpu_torch::cin_chain_fwd`` (a ``torch.library.Library``
  schema with a CUDA and a CPU implementation and a fake that gives its
  output shapes), which every path calls, so that ``torch.export`` keeps
  it as one node of a serving artifact (``serving.Predictor.export``).
- K2 ``csrc/cin_chain_bwd.cu`` (the TPU kernel ``_chain_bwd_kernel``):
  the backward from the pooled cotangents to dx0, dW_i and db_i, in two
  forms. The save form (``cin_chain_bwd``) reads the fmaps K1 saved; the
  recompute form (``cin_chain_bwd_recompute``, the reference's
  ``save=False``) rebuilds them from x0c, W and b with K1's own code, so
  no fmap crosses from the forward to the backward.

Both take the reference chain's whole range (``chain_supported``, stated
clause by clause in ``chain_unsupported_reason``): any depth, O_i up to
512, D a power of two up to 1024.

``cin_chain_fm`` is the differentiable entry. When a gradient is needed it
runs one ``torch.autograd.Function``, chosen by ``CHAIN_SAVE_FMAPS`` when
the forward runs: True (the reference's default), K1 with saved fmaps and
K2's save form; False, K1 without fmaps, only x0c and the params kept for
the backward (the reference's residuals), and K2's recompute form.
Otherwise (``no_grad``, ``inference_mode``) the no-save K1 launch. A CUDA
tensor launches the kernels (raising on what they do not take); a CPU
tensor runs the twins.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .cuda_build import load

_SUPPORTED_ACTS = ("identity", "relu", "leaky_relu")
_ACT_CODES = {"identity": 0, "relu": 1, "leaky_relu": 2}

# K1's and K2's blocks own 128 columns each (csrc/cin_chain_fwd.cuh).
_TILE_N = 128
_MAX_SMEM = 232_448  # bytes a block may use on Hopper

# The training forward saves the fmaps for the backward (True, the
# reference's default, recman_tpu/ops/cin_chain.py:85) or keeps only x0c
# and the params, the backward rebuilding the fmaps (False: activation
# memory O(B*D*H0) instead of O(B*D*sum O_i), for very large batches).
# Read when the forward runs.
CHAIN_SAVE_FMAPS = True

# Launches of K1 in either form (LAUNCHES), of its save form alone
# (SAVE_LAUNCHES), of K2's save form (BWD_LAUNCHES) and of K2's recompute
# form (RECOMPUTE_LAUNCHES), counted where the wrappers launch them (and
# nowhere else); callers reset them to 0 to count the launches of one run.
LAUNCHES = 0
SAVE_LAUNCHES = 0
BWD_LAUNCHES = 0
RECOMPUTE_LAUNCHES = 0


def _act(kind, x):
    if kind == "relu":
        return torch.relu(x)
    if kind == "leaky_relu":
        return torch.where(x >= 0, x, 0.2 * x)
    return x


def _act_deriv(kind, fmap):
    """d act / d pre read from the activation's OUTPUT, as the reference
    does (recman_tpu/ops/cin_chain.py:99-107): fmap > 0 <=> pre > 0 for
    the supported set. None for identity (the multiply is skipped)."""
    if kind == "relu":
        return (fmap > 0).to(fmap.dtype)
    if kind == "leaky_relu":
        return torch.where(fmap > 0, 1.0, 0.2).to(fmap.dtype)
    return None


class _LayerCfg(NamedTuple):
    """Static per-layer geometry: fan-in hk, maps o, last layer or not."""

    hk: int
    o: int
    final: bool

    @property
    def feed(self) -> int:
        """Rows of the fmap that feed the next layer (none for the last)."""
        return 0 if self.final else self.o // 2


def _layer_cfgs(h0: int, units) -> list[_LayerCfg]:
    cfgs, hk = [], h0
    for i, o in enumerate(units):
        cfgs.append(_LayerCfg(hk, o, i == len(units) - 1))
        hk = o // 2
    return cfgs


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def k4_weight_layout(w, h0: int, hk: int):
    """bf16(W) as K4 and K1 read it: Wt (O, Kp) bf16 with Wt[o, h*Hk8 + m] =
    bf16(W[h*Hk + m, o]), Hk8 = Hk rounded up to 8, Kp = H0*Hk8 rounded up
    to 64, padding zero."""
    o = w.shape[1]
    hk8 = _round8(hk)
    wt = torch.zeros((o, _round_up(h0 * hk8, 64)), dtype=torch.bfloat16, device=w.device)
    wt[:, : h0 * hk8].view(o, h0, hk8)[:, :, :hk] = w.view(h0, hk, o).permute(2, 0, 1)
    return wt


def k5_weight_layout(w, h0: int, hk: int):
    """bf16(W) as K5 and K2 read it: Wp (H0*Hk8, O64) bf16 with Wp[h*Hk8 + m, o] =
    bf16(W[h*Hk + m, o]), Hk8 = Hk rounded up to 8, O64 = O rounded up to
    64, padding zero."""
    o = w.shape[1]
    hk8 = _round8(hk)
    wp = torch.zeros((h0 * hk8, _round_up(o, 64)), dtype=torch.bfloat16, device=w.device)
    wp.view(h0, hk8, -1)[:, :hk, :o] = w.view(h0, hk, o)
    return wp


def chain_supported(h0: int, units, d: int, bd: int, act) -> bool:
    """Eligibility of the fused chain for this geometry — the reference's
    rule (recman_tpu/ops/cin_chain.py:369-379), so both packages take the
    chain on the same inputs: a supported activation and the geometry of
    ``chain_unsupported_reason``."""
    return act in _SUPPORTED_ACTS and chain_unsupported_reason(h0, units, d, bd) is None


def chain_unsupported_reason(h0: int, units, d: int, bd: int) -> str | None:
    """Why K1 and K2 do not take this geometry, or None when they do: the
    geometry of the reference chain's rule, clause by clause. Its tiles of
    1024 and 2048 columns (B*D a multiple of a tile of at least 128 that D
    divides) come to D a power of two up to 1024 and B*D a multiple of
    max(128, D). The kernels' own plans (``chain_fwd_smem_bytes`` and
    ``cols_plan`` in csrc/) check their shared memory at launch."""
    units = tuple(units)
    if not units:
        return "takes at least one layer"
    if any(u % 2 for u in units[:-1]) or not all(1 <= u <= 512 for u in units):
        return f"takes 1 <= O_i <= 512, non-final O_i even; got {units}"
    if max(c.hk for c in _layer_cfgs(h0, units)) > 128 or h0 < 1:
        return "takes 1 <= H0 and every Hk_i <= 128 (a non-final O_i <= 256)"
    if d < 1 or d > 1024 or d & (d - 1):
        return f"needs D a power of two up to 1024, got D={d}"
    if bd % max(_TILE_N, d):
        return f"needs B*D a multiple of max({_TILE_N}, D), got B*D={bd}"
    return None


def cin_chain_fm_reference(x0c, ws, bs, units, d, act="leaky_relu", save=False, feeds=None):
    """Plain PyTorch version of K1 (the CPU path and K1's oracle).

    x0, xk and W are rounded to bf16 and z is their bf16 product, as in
    the kernel; z and W are then widened to f32 before ``torch.matmul``,
    because a bf16 matmul rounds its output to bf16, which is not the f32
    accumulation the reference uses. Returns the per-layer pooled blocks,
    followed with ``save=True`` by every layer's fmap (O_i, B*D) f32.

    ``feeds`` (optional, one (O_i, B*D) fmap per layer, a kernel's): layer
    i+1 takes the first O_i/2 rows of feeds[i] as its xk in place of its
    own, so that each layer of a kernel is held to this version on the
    same input. Sums in another order can round an xk element to the
    neighbouring bf16 value, which the next layer's products carry.
    """
    h0, bd = x0c.shape
    b = bd // d
    x0b = x0c.to(torch.bfloat16)
    xk = x0c
    outs, fmaps = [], []
    for i, (w, bias, o) in enumerate(zip(ws, bs, units)):
        hk = xk.shape[0]
        z = (x0b[:, None, :] * xk.to(torch.bfloat16)[None, :, :]).reshape(
            h0 * hk, bd
        )
        pre = torch.matmul(w.to(torch.bfloat16).float().t(), z.float())
        fmap = _act(act, pre + bias[:, None])
        fmaps.append(fmap)
        if i != len(units) - 1:
            xk, direct = fmap[: o // 2], fmap[o // 2:]
            if feeds is not None:
                xk = feeds[i][: o // 2]
        else:
            direct = fmap
        outs.append(direct.reshape(direct.shape[0], b, d).sum(2).t().contiguous())
    return tuple(outs) + (tuple(fmaps) if save else ())


def cin_chain_bwd_reference(x0c, ws, bs, gs, fmaps, units, d, act="leaky_relu"):
    """Plain PyTorch version of K2 (the CPU path and K2's oracle): the
    backward formulas of ``_chain_bwd_kernel`` (recman_tpu/ops/
    cin_chain.py:286-355) written out, rounding where it rounds.

    Per layer, in reverse: dfmap = [dxk of the layer above ; g broadcast
    over D]; gpre = dfmap * act'(fmap); db = sum gpre; dW = z @ bf16(gpre)^T
    with z = bf16(bf16(x0) * bf16(xk)); u = bf16(W) @ bf16(gpre) in f32;
    dx0[h] += sum_m u[h*Hk+m] * xk[m] and dxk[m] = sum_h u[h*Hk+m] * x0[h]
    with x0 and xk in f32; layer 0's dxk lands on dx0. ``bs`` is unused,
    as in the reference (the bias gradient comes from gpre).
    Returns (dx0 (H0, B*D), dW_i (H0*Hk_i, O_i), db_i (O_i,)), all f32.
    """
    del bs
    h0, bd = x0c.shape
    cfgs = _layer_cfgs(h0, units)
    n = len(cfgs)
    x0b = x0c.to(torch.bfloat16)
    dx0 = torch.zeros_like(x0c)
    dws, dbs = [None] * n, [None] * n
    dxk_next = None
    for i in reversed(range(n)):
        cfg = cfgs[i]
        g_direct = gs[i].t().repeat_interleave(d, dim=1)  # (F_i, B*D)
        dfmap = g_direct if cfg.final else torch.cat([dxk_next, g_direct], 0)
        deriv = _act_deriv(act, fmaps[i])
        gpre = dfmap if deriv is None else dfmap * deriv
        dbs[i] = gpre.sum(1)
        gpre_bf = gpre.to(torch.bfloat16).float()
        xk = x0c if i == 0 else fmaps[i - 1][: cfg.hk]
        z = (x0b[:, None, :] * xk.to(torch.bfloat16)[None, :, :]).reshape(
            h0 * cfg.hk, bd
        )
        dws[i] = torch.matmul(z.float(), gpre_bf.t())
        u = torch.matmul(ws[i].to(torch.bfloat16).float(), gpre_bf).reshape(
            h0, cfg.hk, bd
        )
        dx0 = dx0 + (u * xk[None, :, :]).sum(1)
        dxk = (u * x0c[:, None, :]).sum(0)
        if i == 0:
            dx0 = dx0 + dxk
        else:
            dxk_next = dxk
    return dx0, tuple(dws), tuple(dbs)


def cin_chain_bwd_recompute_reference(x0c, ws, bs, gs, units, d, act="leaky_relu"):
    """Plain PyTorch version of K2's recompute form (the CPU path and its
    oracle): K1's twin rebuilds the fmaps, then K2's twin runs on them, so
    the two forms give the same bits on the CPU by construction."""
    fmaps = cin_chain_fm_reference(x0c, ws, bs, units, d, act, save=True)[len(units):]
    return cin_chain_bwd_reference(x0c, ws, bs, gs, fmaps, units, d, act)


def _check_chain_args(name, x0c, ws, units, d, act):
    if act not in _SUPPORTED_ACTS:
        raise ValueError(f"{name} activation must be one of {_SUPPORTED_ACTS}, got {act!r}")
    if x0c.dtype != torch.float32 or x0c.dim() != 2 or not x0c.is_contiguous():
        raise ValueError(f"{name} takes x0c as a contiguous (H0, B*D) float32 tensor")
    if x0c.data_ptr() % 16:
        raise ValueError(f"{name} needs x0c 16-byte aligned")
    h0, bd = x0c.shape
    why = chain_unsupported_reason(h0, units, d, bd)
    if why is not None:
        raise ValueError(f"{name} {why}")
    if len(ws) != len(units):
        raise ValueError(f"{name} needs one W per layer")
    for cfg, w in zip(_layer_cfgs(h0, units), ws):
        if tuple(w.shape) != (h0 * cfg.hk, cfg.o):
            raise ValueError(
                f"{name} layer shapes: W {tuple(w.shape)}, "
                f"expected ({h0 * cfg.hk}, {cfg.o})"
            )


def _check_tensor(name, what, t, shape, dtype, device, align=16):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} {what}: got {tuple(t.shape)} {t.dtype}, "
                         f"expected {tuple(shape)} {dtype}")
    if t.device != device:
        raise ValueError(f"{name} needs every tensor on x0c's device")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} {what} must be contiguous and {align}-byte aligned")


def _check_cuda_args(x0c, ws, bs, units, d, act):
    _check_chain_args("K1", x0c, ws, units, d, act)
    if len(bs) != len(units):
        raise ValueError("K1 needs one b per layer")
    h0 = x0c.shape[0]
    for cfg, w, b in zip(_layer_cfgs(h0, units), ws, bs):
        if tuple(b.shape) != (cfg.o,):
            raise ValueError(f"K1 layer shapes: b {tuple(b.shape)}, expected ({cfg.o},)")
        for t in (w, b):
            if t.device != x0c.device:
                raise ValueError("K1 needs every tensor on x0c's device")
            if t.dtype != torch.float32:
                raise ValueError("K1 takes W and b as float32")


def _ptrs(tensors):
    """A C array of the tensors' data pointers (NULL for None)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _k1():
    """K1's C entry point (``cin_chain_fwd`` in csrc/cin_chain_fwd.cu),
    built and loaded at first use."""
    fn = load("cin_chain_fwd").cin_chain_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


@functools.lru_cache(maxsize=None)
def _table_bytes(name: str):
    """``<name>_table_bytes`` of a kernel's source: the bytes of the layers'
    table that each launch writes (the same in every build)."""
    fn = getattr(load(name), f"{name}_table_bytes")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return fn


def _table(name: str, n_layers: int, device):
    """The device memory a kernel's launch writes its layers' table into."""
    return torch.empty((_table_bytes(name)(n_layers),), dtype=torch.uint8, device=device)


def k1_weight_layouts(h0: int, units, ws):
    """bf16(W_i) as K1 reads each layer, once per call: K4's layout
    (``k4_weight_layout``), Hk_i padded to 8 with zeros."""
    return [k4_weight_layout(w, h0, c.hk) for c, w in zip(_layer_cfgs(h0, units), ws)]


def k2_weight_layouts(h0: int, units, ws):
    """bf16(W_i) as K2 reads each layer, once per call: K5's layout
    (``k5_weight_layout``), Hk_i padded to 8 and O_i to 64 with zeros."""
    return [k5_weight_layout(w, h0, c.hk) for c, w in zip(_layer_cfgs(h0, units), ws)]


def _cin_chain_fm_cuda(x0c, ws, bs, units, d, act, save=False):
    global LAUNCHES, SAVE_LAUNCHES
    _check_cuda_args(x0c, ws, bs, units, d, act)
    h0, bd = x0c.shape
    n = len(units)
    cfgs = _layer_cfgs(h0, units)
    fn = _k1()
    w_bf = k1_weight_layouts(h0, units, ws)
    b_c = [b.contiguous() for b in bs]
    outs = [
        torch.empty((bd // d, c.o - c.feed), dtype=torch.float32, device=x0c.device)
        for c in cfgs
    ]
    fmaps = [
        torch.empty((c.o, bd), dtype=torch.float32, device=x0c.device) for c in cfgs
    ] if save else []
    table = _table("cin_chain_fwd", n, x0c.device)
    stream = torch.cuda.current_stream(x0c.device).cuda_stream
    err = fn(
        x0c.data_ptr(), h0, bd, d, n,
        (ctypes.c_int * n)(*units), _ptrs(w_bf), _ptrs(b_c), _ptrs(outs),
        _ptrs(fmaps) if save else None,
        _ACT_CODES[act], table.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 (cin_chain_fwd) launch failed: CUDA error {err}")
    LAUNCHES += 1
    SAVE_LAUNCHES += int(save)
    return tuple(outs) + tuple(fmaps)


def _k2():
    """K2's C entry point (``cin_chain_bwd`` in csrc/cin_chain_bwd.cu)."""
    fn = load("cin_chain_bwd").cin_chain_bwd
    fn.restype = ctypes.c_int
    p = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), p, p, p, p, ctypes.c_void_p, p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, p, p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


def k1_smem(h0: int, units) -> int:
    """K1's shared memory for a geometry in bytes, from the plan of the
    kernel source (``cin_chain_fwd_smem_bytes``)."""
    fn = load("cin_chain_fwd").cin_chain_fwd_smem_bytes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return fn(h0, len(units), (ctypes.c_int * len(units))(*units))


def k2_plan(h0: int, units, bd: int, device) -> tuple[int, list[int]]:
    """K2's launch plan from the kernel source (``cin_chain_bwd_plan``):
    the shared memory of a column-local block in bytes, and each layer's
    column splits of the dW contraction for ``device``'s SM count."""
    fn = load("cin_chain_bwd").cin_chain_bwd_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    n = len(units)
    splits = (ctypes.c_int * n)()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    smem = fn(h0, bd, n, (ctypes.c_int * n)(*units), sms, splits)
    return smem, list(splits)


def _k2_recompute():
    """K2's recompute entry (``cin_chain_bwd_recompute``)."""
    fn = load("cin_chain_bwd").cin_chain_bwd_recompute
    fn.restype = ctypes.c_int
    p = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), p, p, p, p, p, p, p, ctypes.c_void_p, p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, p, p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return fn


def k2_scratch_shapes(h0: int, units, bd: int, splits) -> dict:
    """The shapes of K2's scratch for a geometry and its dW splits: per
    layer bf16(gpre) (O_i, B*D) bf16 for the dW phase (which reads x0 and
    xk_i as they are, in f32); the per-block partial db (B*D/128, sum O_i)
    and the per-split partial dW_i (splits_i, H0*Hk_i, O_i), both f32."""
    cfgs = _layer_cfgs(h0, units)
    return {
        "gb": [(c.o, bd) for c in cfgs],
        "pdb": (bd // _TILE_N, sum(units)),
        "pdw": [(s, h0 * c.hk, c.o) for s, c in zip(splits, cfgs)],
    }


def _k2_buffers(x0c, ws, units):
    """K2's W in the layout it walks, its scratch (its layers' tables
    included) and its outputs, for either form: (splits, wps, gbs, pdb,
    pdws, table, dx0, dws, dbs)."""
    h0, bd = x0c.shape
    dev = x0c.device
    smem, splits = k2_plan(h0, units, bd, dev)
    if smem > _MAX_SMEM:
        raise ValueError(f"K2 needs {smem} bytes of shared memory, over {_MAX_SMEM}")
    shapes = k2_scratch_shapes(h0, units, bd, splits)
    gbs = [torch.empty(s, dtype=torch.bfloat16, device=dev) for s in shapes["gb"]]
    pdb = torch.empty(shapes["pdb"], dtype=torch.float32, device=dev)
    pdws = [torch.empty(s, dtype=torch.float32, device=dev) for s in shapes["pdw"]]
    dx0 = torch.empty_like(x0c)
    dws = [torch.empty(s[1:], dtype=torch.float32, device=dev) for s in shapes["pdw"]]
    dbs = [torch.empty((o,), dtype=torch.float32, device=dev) for o in units]
    table = _table("cin_chain_bwd", len(units), dev)
    return (splits, k2_weight_layouts(h0, units, ws), gbs, pdb, pdws, table, dx0, dws, dbs)


def _check_k2_args(x0c, ws, gs, units, d, act):
    _check_chain_args("K2", x0c, ws, units, d, act)
    h0, bd = x0c.shape
    if len(gs) != len(units):
        raise ValueError("K2 needs one pooled cotangent per layer")
    for cfg, w, g in zip(_layer_cfgs(h0, units), ws, gs):
        _check_tensor("K2", "W", w, (h0 * cfg.hk, cfg.o), torch.float32, x0c.device, align=4)
        _check_tensor("K2", "pooled cotangent", g, (bd // d, cfg.o - cfg.feed),
                      torch.float32, x0c.device, align=4)


def _cin_chain_bwd_cuda(x0c, ws, gs, fmaps, units, d, act):
    global BWD_LAUNCHES
    _check_k2_args(x0c, ws, gs, units, d, act)
    h0, bd = x0c.shape
    n = len(units)
    if len(fmaps) != n:
        raise ValueError("K2 needs one fmap per layer")
    for cfg, f in zip(_layer_cfgs(h0, units), fmaps):
        _check_tensor("K2", "fmap", f, (cfg.o, bd), torch.float32, x0c.device)
    splits, wps, gbs, pdb, pdws, table, dx0, dws, dbs = _k2_buffers(x0c, ws, units)
    stream = torch.cuda.current_stream(x0c.device).cuda_stream
    err = _k2()(
        x0c.data_ptr(), h0, bd, d, n, (ctypes.c_int * n)(*units),
        _ptrs(wps), _ptrs(list(fmaps)), _ptrs(list(gs)), _ptrs(gbs), pdb.data_ptr(),
        _ptrs(pdws), (ctypes.c_int * n)(*splits), dx0.data_ptr(), _ptrs(dws), _ptrs(dbs),
        _ACT_CODES[act], table.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"K2 (cin_chain_bwd) launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return dx0, tuple(dws), tuple(dbs)


def _cin_chain_bwd_recompute_cuda(x0c, ws, bs, gs, units, d, act):
    global RECOMPUTE_LAUNCHES
    _check_cuda_args(x0c, ws, bs, units, d, act)
    _check_k2_args(x0c, ws, gs, units, d, act)
    h0, bd = x0c.shape
    n = len(units)
    cfgs = _layer_cfgs(h0, units)
    dev = x0c.device
    splits, wps, gbs, pdb, pdws, table, dx0, dws, dbs = _k2_buffers(x0c, ws, units)
    w_bf = k1_weight_layouts(h0, units, ws)
    b_c = [b.contiguous() for b in bs]
    # phase 0's scratch: each non-final layer's feed rows (f32) and one bit
    # per fmap element (fmap > 0), alive only for this call
    feeds = [torch.empty((c.feed, bd), dtype=torch.float32, device=dev) if c.feed else None
             for c in cfgs]
    signs = [torch.empty((c.o, bd // 32), dtype=torch.int32, device=dev) for c in cfgs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _k2_recompute()(
        x0c.data_ptr(), h0, bd, d, n, (ctypes.c_int * n)(*units),
        _ptrs(w_bf), _ptrs(b_c), _ptrs(wps), _ptrs(feeds), _ptrs(signs), _ptrs(list(gs)),
        _ptrs(gbs), pdb.data_ptr(), _ptrs(pdws), (ctypes.c_int * n)(*splits),
        dx0.data_ptr(), _ptrs(dws), _ptrs(dbs), _ACT_CODES[act], table.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"K2 (cin_chain_bwd_recompute) launch failed: CUDA error {err}")
    RECOMPUTE_LAUNCHES += 1
    return dx0, tuple(dws), tuple(dbs)


def _on(t, name):
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{name}: no path for device {t.device}")


# K1 as the registered op ``recman_tpu_torch::cin_chain_fwd``: the one
# place it launches. A schema, an implementation per device type (K1 on
# CUDA, the plain version on the CPU) and a fake that gives the output
# shapes, so that ``torch.export`` keeps a call as one graph node and an
# exported program launches K1 where the live model does. The dispatcher
# calls the implementation directly: ``torch.library.custom_op`` would add
# a Python autograd layer and alias checks to every live call.
_LIB = torch.library.Library("recman_tpu_torch", "FRAGMENT")
_LIB.define("cin_chain_fwd(Tensor x0c, Tensor[] ws, Tensor[] bs, int[] units, int d, str act, "
            "bool save) -> Tensor[]")
_LIB.impl("cin_chain_fwd", lambda x0c, ws, bs, units, d, act, save: list(
    _cin_chain_fm_cuda(x0c, ws, bs, tuple(units), d, act, save)), "CUDA")
_LIB.impl("cin_chain_fwd", lambda x0c, ws, bs, units, d, act, save: list(
    cin_chain_fm_reference(x0c, ws, bs, tuple(units), d, act, save)), "CPU")


@torch.library.register_fake("recman_tpu_torch::cin_chain_fwd", lib=_LIB)
def _(x0c, ws, bs, units, d, act, save):
    bd = x0c.shape[1]
    cfgs = _layer_cfgs(x0c.shape[0], units)
    outs = [x0c.new_empty((bd // d, c.o - c.feed)) for c in cfgs]
    return outs + ([x0c.new_empty((c.o, bd)) for c in cfgs] if save else [])


_cin_chain_fwd_op = torch.ops.recman_tpu_torch.cin_chain_fwd.default


def cin_chain_fwd(x0c, ws, bs, units, d, act="leaky_relu", save=False):
    """The chain forward, not differentiable: K1 on a CUDA tensor, the
    plain version on a CPU tensor, through the registered op. Returns the
    pooled blocks and, with ``save=True``, every layer's fmap after
    them."""
    return tuple(_cin_chain_fwd_op(x0c, list(ws), list(bs), list(units), d, act, save))


def cin_chain_bwd(x0c, ws, bs, gs, fmaps, units, d, act="leaky_relu"):
    """The chain backward: K2 on a CUDA tensor, the plain version on a CPU
    tensor. gs are the pooled cotangents, batch-major (B, F_i); fmaps the
    forward's saved fmaps. Returns (dx0, dWs, dbs) with dW_i in the
    reference row order h*Hk+m."""
    units = tuple(units)
    if _on(x0c, "cin_chain_bwd") == "cuda":
        return _cin_chain_bwd_cuda(x0c, list(ws), list(gs), list(fmaps), units, d, act)
    return cin_chain_bwd_reference(x0c, ws, bs, gs, fmaps, units, d, act)


def cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, act="leaky_relu"):
    """The chain backward without saved fmaps: K2's recompute form on a
    CUDA tensor, its plain version on a CPU tensor. Takes the forward's
    inputs and the pooled cotangents; returns what ``cin_chain_bwd``
    returns."""
    units = tuple(units)
    if _on(x0c, "cin_chain_bwd_recompute") == "cuda":
        return _cin_chain_bwd_recompute_cuda(x0c, list(ws), list(bs), list(gs), units, d, act)
    return cin_chain_bwd_recompute_reference(x0c, ws, bs, gs, units, d, act)


class _ChainFm(torch.autograd.Function):
    """K1 with saved fmaps forward, K2's save form backward (the
    reference's ``_chain_fm`` custom_vjp in its CHAIN_SAVE_FMAPS form)."""

    @staticmethod
    def forward(ctx, x0c, units, d, act, *params):
        n = len(units)
        ws = params[:n]
        out = cin_chain_fwd(x0c, ws, params[n:], units, d, act, save=True)
        ctx.cfg = (units, d, act)
        ctx.save_for_backward(x0c, *ws, *out[n:])
        return out[:n]

    @staticmethod
    def backward(ctx, *grads):
        units, d, act = ctx.cfg
        n = len(units)
        saved = ctx.saved_tensors
        x0c, ws, fmaps = saved[0], saved[1:1 + n], saved[1 + n:]
        gs = [g.contiguous() for g in grads]
        dx0, dws, dbs = cin_chain_bwd(x0c, ws, None, gs, fmaps, units, d, act)
        return (dx0, None, None, None, *dws, *dbs)


class _ChainFmRecompute(torch.autograd.Function):
    """K1 without fmaps forward, keeping x0c and the params (the
    reference's residuals); K2's recompute form backward."""

    @staticmethod
    def forward(ctx, x0c, units, d, act, *params):
        n = len(units)
        out = cin_chain_fwd(x0c, params[:n], params[n:], units, d, act)
        ctx.cfg = (units, d, act)
        ctx.save_for_backward(x0c, *params)
        return out

    @staticmethod
    def backward(ctx, *grads):
        units, d, act = ctx.cfg
        n = len(units)
        saved = ctx.saved_tensors
        x0c, ws, bs = saved[0], saved[1:1 + n], saved[1 + n:]
        gs = [g.contiguous() for g in grads]
        dx0, dws, dbs = cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, act)
        return (dx0, None, None, None, *dws, *dbs)


def cin_chain_fm(x0c, ws, bs, units, d, act="leaky_relu"):
    """Fused whole-chain CIN in field-major layout, differentiable.

    x0c (H0, B*D) f32, ws/bs per-layer (H0*Hk_i, O_i)/(O_i,) f32 params in
    the reference row order h*Hk+m, units = cross_layer_units, d =
    embedding size, act in {identity, relu, leaky_relu}. Returns a tuple
    of per-layer pooled direct-connect blocks, each batch-major (B, F_i)
    f32. When a gradient is needed, by ``CHAIN_SAVE_FMAPS``: K1 saves the
    fmaps and the backward runs K2's save form, or K1 saves nothing and
    the backward runs K2's recompute form (their twins on a CPU tensor);
    otherwise the no-save forward.
    """
    units = tuple(units)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x0c, *ws, *bs)
    ):
        fn = _ChainFm if CHAIN_SAVE_FMAPS else _ChainFmRecompute
        return fn.apply(x0c, units, d, act, *ws, *bs)
    return cin_chain_fwd(x0c, ws, bs, units, d, act)
