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

Kernels (sources in ``csrc/``), each beside its plain PyTorch twin, which
is the CPU path and the kernel's oracle:

- K1 ``csrc/cin_chain_fwd.cu`` (the TPU kernel ``_chain_fwd_kernel``):
  the forward. With ``save=True`` it also writes every layer's fmap
  (O_i, B*D) f32 for the backward (``CHAIN_SAVE_FMAPS`` in the
  reference); serving launches it without.
- K2 ``csrc/cin_chain_bwd.cu`` (the TPU kernel ``_chain_bwd_kernel`` in
  its save-fmaps form): the backward from the pooled cotangents and the
  saved fmaps to dx0, dW_i and db_i.

``cin_chain_fm`` is the differentiable entry: when a gradient is needed it
runs K1 with saved fmaps under one ``torch.autograd.Function`` whose
backward runs K2; otherwise (``no_grad``, ``inference_mode``) the no-save
K1 launch. A CUDA tensor launches the kernels (raising on what they do not
take); a CPU tensor runs the twins.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .cuda_build import load

_SUPPORTED_ACTS = ("identity", "relu", "leaky_relu")
_ACT_CODES = {"identity": 0, "relu": 1, "leaky_relu": 2}

# The reference's chain tiles (recman_tpu/ops/cin_chain.py:73-74). They
# are kept only so that ``chain_supported`` accepts exactly the geometry
# the reference routes through its chain; K1 and K2 tile their own way.
CHAIN_TILE_FWD = 1024
CHAIN_TILE_BWD = 2048

# K1's and K2's tiling: 128 columns (whole batch rows) per block, rows in
# groups of 8 per warp; the kernel sources state the same range.
_TILE_N = 128
_MAX_LAYERS = 8
_MAX_O = 256
_MAX_FIELDS = 128
_MAX_SMEM = 232_448  # bytes a block may use on Hopper

# Launches of K1 (LAUNCHES) and K2 (BWD_LAUNCHES), counted where the
# wrappers launch them (and nowhere else); callers reset them to 0 to
# count the launches of one run.
LAUNCHES = 0
BWD_LAUNCHES = 0


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


def _pick_chain_tile(bd: int, d: int, want: int) -> int | None:
    """Largest tile <= want that divides bd, is a multiple of 128 and of d
    (the reference's rule, kept for ``chain_supported``)."""
    t = want
    while t >= 128:
        if bd % t == 0 and t % d == 0 and t % 128 == 0:
            return t
        t //= 2
    return None


def chain_supported(h0: int, units, d: int, bd: int, act) -> bool:
    """Eligibility of the fused chain for this geometry — the reference's
    rule (recman_tpu/ops/cin_chain.py:369-379), so both packages take the
    chain on the same inputs."""
    if act not in _SUPPORTED_ACTS:
        return False
    if not units or any(u % 2 for u in units[:-1]):
        return False
    cfgs = _layer_cfgs(h0, units)
    if max(c.hk for c in cfgs) > 128 or max(c.o for c in cfgs) > 512:
        return False
    return _pick_chain_tile(bd, d, CHAIN_TILE_FWD) is not None and \
        _pick_chain_tile(bd, d, CHAIN_TILE_BWD) is not None


def k1_smem_bytes(h0: int, units) -> int:
    """Shared memory of one K1 block (the formula of the kernel source)."""
    cfgs = _layer_cfgs(h0, units)
    max_hk = max(c.hk for c in cfgs)
    max_feed = max(c.feed for c in cfgs)
    max_wchunk = max(c.hk * _round8(c.o) for c in cfgs)
    return ((h0 + max_feed + max_hk) * _TILE_N + max_wchunk) * 4


def k1_unsupported_reason(h0: int, units, d: int, bd: int) -> str | None:
    """Why K1 does not take this geometry, or None when it does."""
    units = tuple(units)
    if not 1 <= len(units) <= _MAX_LAYERS:
        return f"K1 takes 1..{_MAX_LAYERS} layers, got {len(units)}"
    if d < 1 or _TILE_N % d:
        return f"K1 needs D dividing {_TILE_N}, got D={d}"
    if bd % _TILE_N:
        return f"K1 needs B*D a multiple of {_TILE_N}, got {bd}"
    if any(u % 2 for u in units[:-1]) or not all(1 <= u <= _MAX_O for u in units):
        return f"K1 takes 1 <= O_i <= {_MAX_O}, non-final O_i even; got {units}"
    if max(c.hk for c in _layer_cfgs(h0, units)) > _MAX_FIELDS:
        return f"K1 takes H0 and Hk_i <= {_MAX_FIELDS}"
    smem = k1_smem_bytes(h0, units)
    if smem > _MAX_SMEM:
        return f"K1 needs {smem} bytes of shared memory, over {_MAX_SMEM}"
    return None


def k2_unsupported_reason(h0: int, units, d: int, bd: int) -> str | None:
    """Why K2 does not take this geometry by K1's range (it runs on K1's
    saved fmaps), or None when it does. Its own shared memory is checked
    at launch, by the plan of the kernel source (``k2_plan``)."""
    reason = k1_unsupported_reason(h0, units, d, bd)
    return None if reason is None else reason.replace("K1", "K2")


def cin_chain_fm_reference(x0c, ws, bs, units, d, act="leaky_relu", save=False):
    """Plain PyTorch version of K1 (the CPU path and K1's oracle).

    x0, xk and W are rounded to bf16 and z is their bf16 product, as in
    the kernel; z and W are then widened to f32 before ``torch.matmul``,
    because a bf16 matmul rounds its output to bf16, which is not the f32
    accumulation the reference uses. Returns the per-layer pooled blocks,
    followed with ``save=True`` by every layer's fmap (O_i, B*D) f32.
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


def _check_chain_args(name, x0c, ws, units, d, act, reason):
    if act not in _SUPPORTED_ACTS:
        raise ValueError(f"{name} activation must be one of {_SUPPORTED_ACTS}, got {act!r}")
    if x0c.dtype != torch.float32 or x0c.dim() != 2 or not x0c.is_contiguous():
        raise ValueError(f"{name} takes x0c as a contiguous (H0, B*D) float32 tensor")
    if x0c.data_ptr() % 16:
        raise ValueError(f"{name} needs x0c 16-byte aligned")
    h0, bd = x0c.shape
    why = reason(h0, units, d, bd)
    if why is not None:
        raise ValueError(why)
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
    _check_chain_args("K1", x0c, ws, units, d, act, k1_unsupported_reason)
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
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _k1():
    """K1's C entry point (``cin_chain_fwd`` in csrc/cin_chain_fwd.cu),
    built and loaded at first use."""
    fn = load("cin_chain_fwd").cin_chain_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _cin_chain_fm_cuda(x0c, ws, bs, units, d, act, save=False):
    global LAUNCHES
    _check_cuda_args(x0c, ws, bs, units, d, act)
    h0, bd = x0c.shape
    n = len(units)
    cfgs = _layer_cfgs(h0, units)
    fn = _k1()
    # W to bf16 once per call, columns zero-padded to a multiple of 8 so
    # the kernel reads each row in 16-byte pieces
    w_bf = []
    for cfg, w in zip(cfgs, ws):
        wb = torch.zeros((w.shape[0], _round8(cfg.o)), dtype=torch.bfloat16, device=w.device)
        wb[:, : cfg.o] = w
        w_bf.append(wb)
    b_c = [b.contiguous() for b in bs]
    outs = [
        torch.empty((bd // d, c.o - c.feed), dtype=torch.float32, device=x0c.device)
        for c in cfgs
    ]
    fmaps = [
        torch.empty((c.o, bd), dtype=torch.float32, device=x0c.device) for c in cfgs
    ] if save else []
    stream = torch.cuda.current_stream(x0c.device).cuda_stream
    err = fn(
        x0c.data_ptr(), h0, bd, d, n,
        (ctypes.c_int * n)(*units), _ptrs(w_bf), _ptrs(b_c), _ptrs(outs),
        _ptrs(fmaps) if save else None,
        _ACT_CODES[act], stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 (cin_chain_fwd) launch failed: CUDA error {err}")
    LAUNCHES += 1
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
        ctypes.c_void_p,
    ]
    return fn


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


def _cin_chain_bwd_cuda(x0c, ws, gs, fmaps, units, d, act):
    global BWD_LAUNCHES
    _check_chain_args("K2", x0c, ws, units, d, act, k2_unsupported_reason)
    h0, bd = x0c.shape
    b = bd // d
    n = len(units)
    cfgs = _layer_cfgs(h0, units)
    dev = x0c.device
    if len(gs) != n or len(fmaps) != n:
        raise ValueError("K2 needs one pooled cotangent and one fmap per layer")
    for cfg, w, g, f in zip(cfgs, ws, gs, fmaps):
        _check_tensor("K2", "W", w, (h0 * cfg.hk, cfg.o), torch.float32, dev, align=4)
        _check_tensor("K2", "pooled cotangent", g, (b, cfg.o - cfg.feed),
                      torch.float32, dev, align=4)
        _check_tensor("K2", "fmap", f, (cfg.o, bd), torch.float32, dev)
    smem, splits = k2_plan(h0, units, bd, dev)
    if smem > _MAX_SMEM:
        raise ValueError(f"K2 needs {smem} bytes of shared memory, over {_MAX_SMEM}")
    fn = _k2()
    # W to bf16 once per call in the layout the kernel walks: per field h
    # the (O, Hk) block W[h*Hk + m, o] transposed, Hk zero-padded to 8
    wts = []
    for cfg, w in zip(cfgs, ws):
        wt = torch.zeros((h0, cfg.o, _round8(cfg.hk)), dtype=torch.bfloat16, device=dev)
        wt[:, :, : cfg.hk] = w.reshape(h0, cfg.hk, cfg.o).transpose(1, 2)
        wts.append(wt)
    # scratch: bf16 gpre transposed to (B*D, O_pad), per-block partial db,
    # per-split partial dW
    gts = [torch.empty((bd, _round8(c.o)), dtype=torch.bfloat16, device=dev) for c in cfgs]
    pdb = torch.empty((bd // _TILE_N, sum(units)), dtype=torch.float32, device=dev)
    pdws = [torch.empty((s, h0 * c.hk, c.o), dtype=torch.float32, device=dev)
            for s, c in zip(splits, cfgs)]
    dx0 = torch.empty_like(x0c)
    dws = [torch.empty((h0 * c.hk, c.o), dtype=torch.float32, device=dev) for c in cfgs]
    dbs = [torch.empty((c.o,), dtype=torch.float32, device=dev) for c in cfgs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        x0c.data_ptr(), h0, bd, d, n, (ctypes.c_int * n)(*units),
        _ptrs(wts), _ptrs(list(fmaps)), _ptrs(list(gs)), _ptrs(gts), pdb.data_ptr(),
        _ptrs(pdws), (ctypes.c_int * n)(*splits), dx0.data_ptr(), _ptrs(dws),
        _ptrs(dbs), _ACT_CODES[act], stream,
    )
    if err != 0:
        raise RuntimeError(f"K2 (cin_chain_bwd) launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return dx0, tuple(dws), tuple(dbs)


def _on(t, name):
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{name}: no path for device {t.device}")


def cin_chain_fwd(x0c, ws, bs, units, d, act="leaky_relu", save=False):
    """The chain forward, not differentiable: K1 on a CUDA tensor, the
    plain version on a CPU tensor. Returns the pooled blocks and, with
    ``save=True``, every layer's fmap after them."""
    units = tuple(units)
    if _on(x0c, "cin_chain_fwd") == "cuda":
        return _cin_chain_fm_cuda(x0c, list(ws), list(bs), units, d, act, save)
    return cin_chain_fm_reference(x0c, ws, bs, units, d, act, save)


def cin_chain_bwd(x0c, ws, bs, gs, fmaps, units, d, act="leaky_relu"):
    """The chain backward: K2 on a CUDA tensor, the plain version on a CPU
    tensor. gs are the pooled cotangents, batch-major (B, F_i); fmaps the
    forward's saved fmaps. Returns (dx0, dWs, dbs) with dW_i in the
    reference row order h*Hk+m."""
    units = tuple(units)
    if _on(x0c, "cin_chain_bwd") == "cuda":
        return _cin_chain_bwd_cuda(x0c, list(ws), list(gs), list(fmaps), units, d, act)
    return cin_chain_bwd_reference(x0c, ws, bs, gs, fmaps, units, d, act)


class _ChainFm(torch.autograd.Function):
    """K1 with saved fmaps forward, K2 backward (the reference's
    ``_chain_fm`` custom_vjp in its CHAIN_SAVE_FMAPS form)."""

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


def cin_chain_fm(x0c, ws, bs, units, d, act="leaky_relu"):
    """Fused whole-chain CIN in field-major layout, differentiable.

    x0c (H0, B*D) f32, ws/bs per-layer (H0*Hk_i, O_i)/(O_i,) f32 params in
    the reference row order h*Hk+m, units = cross_layer_units, d =
    embedding size, act in {identity, relu, leaky_relu}. Returns a tuple
    of per-layer pooled direct-connect blocks, each batch-major (B, F_i)
    f32. When a gradient is needed, K1 saves the fmaps and the backward
    runs K2 (their twins on a CPU tensor); otherwise the no-save forward.
    """
    units = tuple(units)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x0c, *ws, *bs)
    ):
        return _ChainFm.apply(x0c, units, d, act, *ws, *bs)
    return cin_chain_fwd(x0c, ws, bs, units, d, act)
