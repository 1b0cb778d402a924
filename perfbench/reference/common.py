"""Plain PyTorch pieces of the references: rounding to a stated precision,
matrix products that round their operands, one CIN layer, the loss, the
optimizers and the learning-rate schedule.

A precision is a dict ``{"gemm": ..., "cin": ...}``. ``gemm`` is "f32"
(float32 products and sums, TF32 off) or "tf32" (operands rounded to
TF32's 10-bit mantissa, to nearest, with float32 sums, forward and
backward: what a TF32 tensor core computes). ``cin`` is "bf16" (the CIN's
operands and the products x0 * xk rounded to bfloat16, float32 sums) or
"fp8" (the same in float8 e4m3 with a per-tensor scale that maps the
largest magnitude to 448). Products of bfloat16 or TF32 values are exact
in float32, so a float32 matrix product with TF32 off computes them with
float32 sums. Nothing here imports the port.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

FP8_MAX = 448.0
LEAKY_SLOPE = 0.2  # TensorFlow's leaky_relu, the xDeepFM reference's


def set_float32_exact():
    """float32 matrix products in float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties to even)."""
    x = x.contiguous()
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = torch.where(torch.isfinite(x), (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000, u)
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float8 e4m3 at a per-tensor scale, back in float32."""
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def round_to(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "f32":
        return x
    if kind == "tf32":
        return round_tf32(x)
    if kind == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if kind == "fp8":
        return round_fp8(x)
    raise ValueError(f"unknown precision {kind!r}")


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with both operands rounded, in the backward too."""

    @staticmethod
    def forward(ctx, a, b, kind):
        ctx.save_for_backward(a, b)
        ctx.kind = kind
        return torch.matmul(round_to(a, kind), round_to(b, kind))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        k = ctx.kind
        g = round_to(g, k)
        ga = torch.matmul(g, round_to(b, k).transpose(-1, -2))
        gb = torch.matmul(round_to(a, k).transpose(-1, -2), g)
        if gb.dim() > b.dim():  # b broadcast over a batch
            gb = gb.sum(0)
        return ga, gb, None


def matmul(a, b, prec: dict):
    """a @ b at the precision's ``gemm``."""
    if prec["gemm"] == "f32":
        return torch.matmul(a, b)
    return _RoundedMatmul.apply(a, b, prec["gemm"])


def _products(x0, xk, kind):
    """z[n, h * Hk + m] = x0[n, h] * xk[n, m], operands and products
    rounded to ``kind``; x0 (N, H0), xk (N, Hk) -> (N, H0 * Hk) f32."""
    if kind == "bf16":
        z = x0.to(torch.bfloat16)[:, :, None] * xk.to(torch.bfloat16)[:, None, :]
        return z.reshape(x0.shape[0], -1).to(torch.float32)
    z = round_to(x0, kind)[:, :, None] * round_to(xk, kind)[:, None, :]
    return round_to(z.reshape(x0.shape[0], -1), kind)


class _CinLayer(torch.autograd.Function):
    """pre[n, o] = sum_x z[n, x] * W[x, o], with n = (b, d), z the rounded
    products of x0 and xk and W rounded; the backward rounds the
    pre-activation's gradient g: dW = z^T g, u = g W^T, dx0[h] = sum_m
    u[h, m] xk[m], dxk[m] = sum_h u[h, m] x0[h], the last two in float32."""

    @staticmethod
    def forward(ctx, x0, xk, w, kind):
        ctx.save_for_backward(x0, xk, w)
        ctx.kind = kind
        return torch.matmul(_products(x0, xk, kind), round_to(w, kind))

    @staticmethod
    def backward(ctx, g):
        x0, xk, w = ctx.saved_tensors
        k = ctx.kind
        g = round_to(g, k)
        dw = torch.matmul(_products(x0, xk, k).t(), g)
        u = torch.matmul(g, round_to(w, k).t()).view(x0.shape[0], x0.shape[1], xk.shape[1])
        dx0 = (u * xk[:, None, :]).sum(2)
        dxk = (u * x0[:, :, None]).sum(1)
        return dx0, dxk, dw, None


def cin_layer(x0, xk, w, prec: dict):
    """One CIN layer's pre-activation without bias: x0 (N, H0), xk (N, Hk)
    -> (N, O), at the precision's ``cin``."""
    y = _CinLayer.apply(x0, xk, w, prec["cin"])
    note_terms(y, w, lambda g: (None, _products(x0.detach().abs(), xk.detach().abs(),
                                                prec["cin"]).t() @ g))
    return y


# While ``term_sums`` is open, each op that takes a leaf notes, from the
# cotangent g of its output, the sum over rows of the magnitudes of that
# leaf's terms: |x|^T |g| for x @ W, the column sums of |g| for a bias,
# |g| by row id for gathered rows. (id(leaf) -> name, {name: [part]}).
_TERMS = None


@contextlib.contextmanager
def term_sums(leaves: dict, parts: dict):
    """Collect the parts of each leaf of ``leaves`` ({name: tensor}) into
    ``parts``: [(flat index or None for the whole leaf, magnitudes)]."""
    global _TERMS
    _TERMS = ({id(v): k for k, v in leaves.items()}, parts)
    try:
        yield
    finally:
        _TERMS = None


def note_terms(y, leaf, part):
    """Note ``part(|g|)`` for ``leaf`` when y's cotangent g arrives."""
    if _TERMS is None or not y.requires_grad or id(leaf) not in _TERMS[0]:
        return
    parts = _TERMS[1].setdefault(_TERMS[0][id(leaf)], [])
    y.register_hook(lambda g: parts.append(part(g.detach().abs())))


def term_magnitude(leaf, parts) -> float:
    """The norm of the sum of a leaf's terms' magnitudes (the ``parts``
    ``term_sums`` collected for it)."""
    total = torch.zeros(leaf.numel(), dtype=torch.float32, device=leaf.device)
    for index, value in parts:
        if index is None:
            total += value.reshape(-1)
        else:
            total.index_add_(0, index, value.reshape(-1))
    return float(torch.linalg.vector_norm(total, dtype=torch.float64))


def dense(x, w, prec: dict):
    """x @ w (x (N, I), w (I, O)) at the precision's ``gemm``."""
    y = matmul(x, w, prec)
    note_terms(y, w, lambda g: (None, x.detach().abs().t() @ g))
    return y


def add_bias(y, b):
    """y + b, b broadcast over y's rows."""
    out = y + b
    note_terms(out, b, lambda g: (None, g.reshape(-1, b.numel()).sum(0)))
    return out


def rows(table, idx):
    """table[idx]: rows of a (V, k) table, or entries of a vector."""
    out = table[idx]

    def part(g):
        k = table.shape[1] if table.dim() == 2 else 1
        flat = idx.reshape(-1, 1).long() * k + torch.arange(k, device=idx.device)
        return flat.reshape(-1), g
    note_terms(out, table, part)
    return out


def activation(name: str):
    if name == "relu":
        return torch.relu
    if name == "leaky_relu":
        return lambda x: torch.where(x >= 0, x, LEAKY_SLOPE * x)
    if name == "identity":
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")


def half_l2(x) -> torch.Tensor:
    """sum(x ** 2) / 2."""
    return 0.5 * torch.sum(x * x)


def bce(y, p, eps=1e-7):
    """Binary cross-entropy of probabilities clipped to [eps, 1 - eps]."""
    p = torch.clamp(p, eps, 1.0 - eps)
    return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


def schedule(spec: dict, batch: int):
    """The learning rate at an optimizer's step count (before the count
    increments): "constant", or "large_batch": peak = base_lr * batch /
    base_batch, a linear warmup from 0 over warmup_frac of the horizon,
    then cosine decay to 0 over the rest, each evaluated in float32 as
    optax's ``linear_schedule`` and ``cosine_decay_schedule`` define them
    (warmup: (0 - peak) * (1 - c / W) + peak)."""
    if spec["kind"] == "constant":
        return lambda count: np.float32(spec["lr"])
    if spec["kind"] != "large_batch":
        raise ValueError(f"unknown schedule {spec['kind']!r}")
    f32 = np.float32
    peak = spec["base_lr"] * (batch / spec["base_batch"])
    total = math.ceil(spec["horizon_examples"] / batch)
    warm = max(int(total * spec["warmup_frac"]), 1)
    rest = max(total - warm, 1)

    def lr(count):
        if count < warm:
            return f32(0.0 - peak) * (f32(1) - f32(count) / f32(warm)) + f32(peak)
        c = f32(min(count - warm, rest))
        return f32(peak) * (f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(rest))))

    return lr


class Optimizer:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected by the step count)
    or plain SGD, each leaf in float32: p <- p - lr * update."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, name: str, lr):
        if name not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name, self.lr, self.count = name, lr, 0
        self.mu, self.nu = {}, {}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        lr = torch.tensor(float(self.lr(self.count)), dtype=torch.float32)
        self.count += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            if self.name == "sgd":
                out[k] = p + (-lr.to(p.device)) * g
                continue
            mu = (1 - self.B1) * g + self.B1 * self.mu.get(k, torch.zeros_like(g))
            nu = (1 - self.B2) * (g * g) + self.B2 * self.nu.get(k, torch.zeros_like(g))
            self.mu[k], self.nu[k] = mu, nu
            bc1 = 1 - torch.tensor(self.B1, dtype=torch.float32) ** self.count
            bc2 = 1 - torch.tensor(self.B2, dtype=torch.float32) ** self.count
            upd = (mu / bc1.to(g.device)) / (torch.sqrt(nu / bc2.to(g.device)) + self.EPS)
            out[k] = p + (-lr.to(p.device)) * upd
        return out
