"""MaskNet building blocks (arXiv:2102.07619): ``LayerNorm`` only.

Counterpart of ``recman_tpu/layers/masknet.py:30-48``, whose LayerNorm
BST's encoder uses. ``MaskBlock`` comes with MaskNet (ROADMAP.md
queue 1).
"""

from __future__ import annotations

import torch


class LayerNorm:
    """LN over the last axis with learnable (dim,) gain/bias:
    ``{prefix}ln_gamma`` (ones) and ``{prefix}ln_beta`` (zeros). The
    variance is the population variance, and eps 1e-6 is added inside the
    rsqrt, as in the reference."""

    def __init__(self, dim: int, prefix: str, eps: float = 1e-6):
        self.dim = int(dim)
        self.prefix = prefix
        self.eps = float(eps)

    def init(self, device=None) -> dict:
        return {
            f"{self.prefix}ln_gamma": torch.ones((self.dim,), dtype=torch.float32, device=device),
            f"{self.prefix}ln_beta": torch.zeros((self.dim,), dtype=torch.float32, device=device),
        }

    def apply(self, params, x) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * params[f"{self.prefix}ln_gamma"] + params[f"{self.prefix}ln_beta"]
