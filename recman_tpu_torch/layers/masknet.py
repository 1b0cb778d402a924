"""MaskNet building blocks (arXiv:2102.07619): ``LayerNorm`` (which
BST's encoder uses too) and ``MaskBlock``.

Counterpart of ``recman_tpu/layers/masknet.py``. A MaskBlock multiplies
its input by an instance-guided mask, a two-layer aggregation/projection
MLP over the raw feature embeddings, then projects through a hidden
matrix with layer normalization and ReLU:

    mask  = relu(V_emb W_agg + b_agg) W_proj + b_proj      (eq. 8-9)
    V_out = relu(LN((mask * x) W_hid))                     (eq. 10-13)

Plain PyTorch, f32.
"""

from __future__ import annotations

import torch

from ..utils import glorot_normal, l2_loss, split_rng


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


class MaskBlock:
    """One instance-guided mask block: x (B, input_dim), V_emb (B,
    mask_input_dim) -> (B, output_dim). Params ``{prefix}agg_w``,
    ``agg_b``, ``proj_w``, ``proj_b``, ``hidden_w`` and the LayerNorm's
    ``ln_gamma``, ``ln_beta``."""

    def __init__(self, mask_input_dim: int, input_dim: int, output_dim: int, agg_dim: int,
                 l2_reg: float = 0.0, prefix: str = "mask_block_"):
        self.mask_input_dim = int(mask_input_dim)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.agg_dim = int(agg_dim)
        self.l2_reg = float(l2_reg)
        self.prefix = prefix
        self.ln = LayerNorm(self.output_dim, prefix=prefix)

    def init(self, generator, device=None) -> dict:
        k_agg, k_proj, k_hid = split_rng(generator, 3)
        p = self.prefix

        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32, device=device)

        params = {
            f"{p}agg_w": glorot_normal(k_agg, (self.mask_input_dim, self.agg_dim), device=device),
            f"{p}agg_b": zeros(self.agg_dim),
            f"{p}proj_w": glorot_normal(k_proj, (self.agg_dim, self.input_dim), device=device),
            f"{p}proj_b": zeros(self.input_dim),
            f"{p}hidden_w": glorot_normal(k_hid, (self.input_dim, self.output_dim), device=device),
        }
        params.update(self.ln.init(device))
        return params

    def mask(self, params, mask_input) -> torch.Tensor:
        """The instance-guided mask (B, input_dim) from the raw embeddings."""
        p = self.prefix
        a = torch.relu(mask_input @ params[f"{p}agg_w"] + params[f"{p}agg_b"])
        return a @ params[f"{p}proj_w"] + params[f"{p}proj_b"]

    def apply(self, params, x, mask_input) -> torch.Tensor:
        hidden = (x * self.mask(params, mask_input)) @ params[f"{self.prefix}hidden_w"]
        return torch.relu(self.ln.apply(params, hidden))

    def l2(self, params):
        if self.l2_reg == 0.0:
            return 0.0
        p = self.prefix
        return self.l2_reg * (l2_loss(params[f"{p}agg_w"]) + l2_loss(params[f"{p}proj_w"])
                              + l2_loss(params[f"{p}hidden_w"]))
