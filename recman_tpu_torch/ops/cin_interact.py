"""One CIN layer's interaction, batch-major (plain PyTorch) and field-major
(kernels K4 forward and K5 backward).

Counterpart of ``recman_tpu/ops/cin_interact.py``. The layer computes

    pre[o, n] = sum_{h,m} x0[h, n] * xk[m, n] * W[h*Hk + m, o]

with z[h*Hk+m, n] = bf16(bf16(x0[h, n]) * bf16(xk[m, n])) and W rounded
to bf16 as the multiplicands and f32 sums, as in the reference.

- ``cin_interact`` (reference :57-73, :342-348): the batch-major (B, D, H)
  form, the counterpart of the reference's XLA einsum. Plain PyTorch on
  either device (``torch.matmul`` on the card); it is no kernel.
- ``cin_interact_fm`` (reference :280-339): the field-major form, x0c
  (H0, B*D), xkc (Hk, B*D), W (H0*Hk, O) -> (O, B*D) f32, differentiable.
  On a CUDA tensor it launches K4 (``csrc/cin_interact_fwd.cu``, the TPU
  kernel ``_fwd_kernel``; the registered op
  ``recman_tpu_torch::cin_interact_fwd``, kept whole by ``torch.export``)
  forward and K5 (``csrc/cin_interact_bwd.cu``,
  ``_bwd_kernel``) backward; on a CPU tensor their plain twins
  ``cin_interact_fm_reference`` and ``cin_interact_fm_bwd_reference``.
  The backward returns dx0 and dxk separately: the first layer passes the
  same tensor as both, and autograd sums the two.

The reference's W repacking (``_pack_w``, ``_pack_dims``) and tile choice
(``_pick_tile``) follow the TPU's VMEM and sublane layout and are not
ported. The kernels run on the tensor cores and take bf16(W) in layouts of
their own, with Hk padded to 8 so that 8 rows of z never straddle two
fields (``k4_weight_layout``, ``k5_weight_layout``: one bf16 copy per
call); K5 returns dW in the reference row order h*Hk+m.

``pallas_cin`` and ``pallas_cin_active`` are the reference's thread-local
switch of the field-major path (:297-329), named as there.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from .cin_chain import _on, _round_up, k4_weight_layout, k5_weight_layout
from .cuda_build import load
from .embedding import _mode as _fused_mode

# Launches of K4 (LAUNCHES) and of K5 (BWD_LAUNCHES), counted where the
# wrappers launch them (and nowhere else); callers reset them to 0 to
# count the launches of one run.
LAUNCHES = 0
BWD_LAUNCHES = 0

# The range K4 and K5 take (the kernel sources check the same): any H0
# and B*D, fan-in Hk <= 128, 1 <= O <= 512.
MAX_HK = 128
MAX_O = 512


def _batch_major_z(x0t, xkt, dtype):
    """z (B, D, H0*Hk): the product of two ``dtype`` tensors rounds to
    ``dtype``, like the reference's z."""
    b, d, h0 = x0t.shape
    return (x0t.to(dtype)[..., :, None] * xkt.to(dtype)[..., None, :]).reshape(
        b, d, h0 * xkt.shape[2]
    )


class _InteractBf16(torch.autograd.Function):
    """The bf16 batch-major interaction with the backward that XLA's
    autodiff derives from the reference's einsum (the vjp's jaxpr): every
    sum runs in f32 and these results round to bf16, where the reference's
    convert_element_type ops stand:

    - dW = bf16(z^T . g), the cotangent of W's bf16 cast;
    - dz = bf16(g . bf16(W)^T);
    - dxk[m] = bf16(sum_h dz[h, m] * bf16(x0[h])) and dx0[h] =
      bf16(sum_m dz[h, m] * bf16(xk[m])), the cotangents of the inputs'
      bf16 casts, returned widened to f32.
    """

    @staticmethod
    def forward(ctx, x0t, xkt, w):
        bf = torch.bfloat16
        x0b, xkb, wb = x0t.to(bf), xkt.to(bf), w.to(bf)
        z = _batch_major_z(x0b, xkb, bf)
        ctx.save_for_backward(x0b, xkb, z, wb)
        # f32 operands holding the rounded values: a bf16 matmul would
        # round its output to bf16, not the reference's f32 accumulation
        return torch.matmul(z.float(), wb.float())

    @staticmethod
    def backward(ctx, g):
        x0b, xkb, z, wb = ctx.saved_tensors
        bf = torch.bfloat16
        b, d, h0 = x0b.shape
        hk = xkb.shape[2]
        g = g.float()
        dw = torch.matmul(z.reshape(b * d, -1).float().t(), g.reshape(b * d, -1))
        dz = torch.matmul(g, wb.float().t()).to(bf).float().reshape(b, d, h0, hk)
        dxk = (dz * x0b.float()[..., :, None]).sum(2)
        dx0 = (dz * xkb.float()[..., None, :]).sum(3)
        return (dx0.to(bf).float(), dxk.to(bf).float(), dw.to(bf).float())


def cin_interact(x0t, xkt, w, dtype=torch.bfloat16):
    """x0t (B, D, H0), xkt (B, D, Hk), w (H0*Hk, O) -> (B, D, O) f32.

    In bf16 (the default) the gradient rounds where the reference's does
    (``_InteractBf16``); in f32 plain autograd is already exact."""
    if dtype == torch.bfloat16:
        return _InteractBf16.apply(x0t, xkt, w)
    return torch.matmul(_batch_major_z(x0t, xkt, dtype).float(), w.to(dtype).float())


# -- the field-major switch ---------------------------------------------------

_state = threading.local()


@contextlib.contextmanager
def pallas_cin(enabled: bool | None):
    """Force the field-major path (K4/K5 and the chain) on or off (None =
    auto). The name is the reference's."""
    prev = getattr(_state, "mode", "auto")
    _state.mode = "auto" if enabled is None else ("on" if enabled else "off")
    try:
        yield
    finally:
        _state.mode = prev


def pallas_cin_active(hk: int) -> bool:
    """Should a CIN whose widest fan-in is ``hk`` run field-major?

    The reference's rule (:320-329) with its TPU test dropped: off under
    ``pallas_cin(False)`` or ``fused_grad(False)`` and for hk > 128, on
    otherwise, on either device (the CPU runs the kernels' twins, as it
    does for the chain)."""
    if getattr(_state, "mode", "auto") == "off" or _fused_mode() == "off":
        return False
    return hk <= MAX_HK


# -- plain twins ----------------------------------------------------------------


def _z(x0c, xkc):
    """z (H0*Hk, B*D) bf16: one rounding of the product of two bf16 values."""
    h0, bd = x0c.shape
    return (x0c.to(torch.bfloat16)[:, None, :] * xkc.to(torch.bfloat16)[None, :, :]).reshape(
        h0 * xkc.shape[0], bd
    )


def cin_interact_fm_reference(x0c, xkc, w):
    """Plain PyTorch version of K4 (the CPU path and K4's oracle):
    pre = bf16(W)^T z in f32 sums. z and W are widened to f32 before
    ``torch.matmul``, because a bf16 matmul would round its output."""
    return torch.matmul(w.to(torch.bfloat16).float().t(), _z(x0c, xkc).float())


def cin_interact_fm_bwd_reference(x0c, xkc, w, g):
    """Plain PyTorch version of K5 (the CPU path and K5's oracle): the
    formulas of ``_bwd_kernel`` (reference :157-205) written out, rounding
    where it rounds. With gb = bf16(g):

        u   = bf16(W) gb                      (H0*Hk, B*D), f32 sums
        dx0 = sum_m u[h*Hk+m] * xk[m]          xk in f32
        dxk = sum_h u[h*Hk+m] * x0[h]          x0 in f32
        dW  = z gb^T                           f32

    Returns (dx0 (H0, B*D), dxk (Hk, B*D), dW (H0*Hk, O)), all f32."""
    h0, bd = x0c.shape
    hk = xkc.shape[0]
    gb = g.to(torch.bfloat16).float()
    u = torch.matmul(w.to(torch.bfloat16).float(), gb).reshape(h0, hk, bd)
    dx0 = (u * xkc[None, :, :]).sum(1)
    dxk = (u * x0c[:, None, :]).sum(0)
    dw = torch.matmul(_z(x0c, xkc).float(), gb.t())
    return dx0, dxk, dw


# -- K4 and K5 --------------------------------------------------------------


def _check(name, x0c, xkc, w, g=None):
    """Raise on what the kernels do not take."""
    tensors = {"x0c": x0c, "xkc": xkc, "W": w}
    if g is not None:
        tensors["g"] = g
    for what, t in tensors.items():
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} takes {what} as a contiguous 2-D float32 tensor")
        if t.device != x0c.device:
            raise ValueError(f"{name} needs every tensor on x0c's device")
    h0, bd = x0c.shape
    hk = xkc.shape[0]
    x, o = w.shape
    if xkc.shape[1] != bd or x != h0 * hk:
        raise ValueError(f"{name} shapes: x0c {tuple(x0c.shape)}, xkc {tuple(xkc.shape)}, "
                         f"W {tuple(w.shape)}; expected W ({h0 * hk}, O)")
    if not 1 <= hk <= MAX_HK or not 1 <= o <= MAX_O or h0 < 1 or bd < 1:
        raise ValueError(f"{name} takes 1 <= Hk <= {MAX_HK} and 1 <= O <= {MAX_O}; "
                         f"got H0={h0}, Hk={hk}, O={o}, B*D={bd}")
    if g is not None and tuple(g.shape) != (o, bd):
        raise ValueError(f"{name} cotangent: got {tuple(g.shape)}, expected ({o}, {bd})")


def _fn(source, symbol, argtypes):
    fn = getattr(load(source), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _cin_interact_fwd_cuda(x0c, xkc, w):
    global LAUNCHES
    _check("K4", x0c, xkc, w)
    h0, bd = x0c.shape
    hk = xkc.shape[0]
    o = w.shape[1]
    fn = _fn("cin_interact_fwd", "cin_interact_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _P])
    w_bf = k4_weight_layout(w, h0, hk)
    out = torch.empty((o, bd), dtype=torch.float32, device=x0c.device)
    err = fn(x0c.data_ptr(), xkc.data_ptr(), w_bf.data_ptr(), out.data_ptr(), h0, hk, o, bd,
             torch.cuda.current_stream(x0c.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4 (cin_interact_fwd) launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def k5_splits(h0: int, hk: int, o: int, bd: int, device) -> int:
    """Column splits of K5's dW contraction for ``device``'s SM count, from
    the kernel source (``cin_interact_bwd_splits``)."""
    fn = _fn("cin_interact_bwd", "cin_interact_bwd_splits", [_I, _I, _I, _I, _I])
    return fn(h0, hk, o, bd, torch.cuda.get_device_properties(device).multi_processor_count)


def _cin_interact_bwd_cuda(x0c, xkc, w, g):
    global BWD_LAUNCHES
    _check("K5", x0c, xkc, w, g)
    h0, bd = x0c.shape
    hk = xkc.shape[0]
    o = w.shape[1]
    dev = x0c.device
    splits = k5_splits(h0, hk, o, bd, dev)
    fn = _fn("cin_interact_bwd", "cin_interact_bwd",
             [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P])
    wp = k5_weight_layout(w, h0, hk)
    # scratch: bf16(g), bf16(x0c) and bf16(xkc) for the dW phase, B*D
    # rounded up to 64; per-split partial dW
    sb = torch.empty((o + h0 + hk, _round_up(bd, 64)), dtype=torch.bfloat16, device=dev)
    pdw = torch.empty((splits, h0 * hk, o), dtype=torch.float32, device=dev)
    dx0 = torch.empty_like(x0c)
    dxk = torch.empty_like(xkc)
    dw = torch.empty((h0 * hk, o), dtype=torch.float32, device=dev)
    err = fn(x0c.data_ptr(), xkc.data_ptr(), wp.data_ptr(), g.data_ptr(), sb.data_ptr(),
             pdw.data_ptr(), splits, dx0.data_ptr(), dxk.data_ptr(), dw.data_ptr(),
             h0, hk, o, bd, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5 (cin_interact_bwd) launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return dx0, dxk, dw


# K4 as the registered op ``recman_tpu_torch::cin_interact_fwd``, its one
# launch site: a schema, K4 on CUDA, the plain version on the CPU, and a
# fake for ``torch.export`` (see ``cin_chain``'s op)
_LIB = torch.library.Library("recman_tpu_torch", "FRAGMENT")
_LIB.define("cin_interact_fwd(Tensor x0c, Tensor xkc, Tensor w) -> Tensor")
_LIB.impl("cin_interact_fwd", lambda x0c, xkc, w: _cin_interact_fwd_cuda(x0c, xkc, w), "CUDA")
_LIB.impl("cin_interact_fwd", lambda x0c, xkc, w: cin_interact_fm_reference(x0c, xkc, w), "CPU")


@torch.library.register_fake("recman_tpu_torch::cin_interact_fwd", lib=_LIB)
def _(x0c, xkc, w):
    return x0c.new_empty((w.shape[1], x0c.shape[1]))


_cin_interact_fwd_op = torch.ops.recman_tpu_torch.cin_interact_fwd.default


def cin_interact_fwd(x0c, xkc, w):
    """The field-major forward, not differentiable: K4 on a CUDA tensor, the
    plain version on a CPU tensor, through the registered op
    ``recman_tpu_torch::cin_interact_fwd``, which ``torch.export`` keeps as
    one graph node."""
    return _cin_interact_fwd_op(x0c, xkc, w)


def cin_interact_bwd(x0c, xkc, w, g):
    """The field-major backward: K5 on a CUDA tensor, the plain version on a
    CPU tensor. Returns (dx0, dxk, dW), dW in the reference row order."""
    if _on(x0c, "cin_interact_bwd") == "cuda":
        return _cin_interact_bwd_cuda(x0c, xkc, w, g)
    return cin_interact_fm_bwd_reference(x0c, xkc, w, g)


class _InteractFm(torch.autograd.Function):
    """K4 forward, K5 backward (the reference's ``_interact_fm``
    custom_vjp)."""

    @staticmethod
    def forward(ctx, x0c, xkc, w):
        ctx.save_for_backward(x0c, xkc, w)
        return cin_interact_fwd(x0c, xkc, w)

    @staticmethod
    def backward(ctx, g):
        x0c, xkc, w = ctx.saved_tensors
        return cin_interact_bwd(x0c, xkc, w, g.contiguous())


def cin_interact_fm(x0c, xkc, w):
    """Field-major interaction, differentiable.

    pre[o, n] = sum_{h,m} x0c[h, n] xkc[m, n] W[h*Hk+m, o], n = b*D+d.
    x0c (H0, B*D), xkc (Hk, B*D), w (H0*Hk, O), all f32 -> (O, B*D) f32.
    Where no gradient is needed it is the forward op alone.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x0c, xkc, w)):
        return _InteractFm.apply(x0c, xkc, w)
    return cin_interact_fwd(x0c, xkc, w)
