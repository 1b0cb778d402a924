"""FinalMLP building blocks (arXiv:2304.00902).

Counterpart of ``recman_tpu/layers/final_mlp.py``:

- ``MLPBlock``: a hidden stack with no 1-logit head (unlike ``DNN``); its
  output is a stream's representation. Dropout after each activation, none
  on the input.
- ``FeatureSelectionGate``: a small MLP over a gate context gives
  ``2 / (1 + exp(-x))`` element weights on the flat embeddings (written
  so, not as ``2 * sigmoid``: the two round differently). The context is
  a learnable vector (context-free) or nominated fields' embeddings
  (context-aware).
- ``InteractionAggregation``: multi-head bilinear fusion of two streams,
  logit = b + o1 w1 + o2 w2 + sum_h o1_h^T W_h o2_h (the paper's eq. 5).

Plain PyTorch, f32.
"""

from __future__ import annotations

import torch

from ..utils import glorot_normal, l2_loss, split_rng
from .common import dropout, resolve_activation


class MLPBlock:
    """(B, input_dim) -> (B, hidden_units[-1]). Params
    ``{prefix}layer_{i}_weights`` and ``{prefix}layer_{i}_bias``."""

    def __init__(self, input_dim: int, hidden_units, dropout_keep, activation,
                 l2_reg: float = 0.0, prefix: str = "mlp_"):
        assert len(hidden_units) > 0
        assert len(hidden_units) == len(dropout_keep), (
            "MLPBlock dropout_keep is per hidden layer (no input dropout)"
        )
        self.input_dim = int(input_dim)
        self.hidden_units = tuple(int(u) for u in hidden_units)
        self.dropout_keep = tuple(dropout_keep)
        self.activation = resolve_activation(activation)
        self.l2_reg = float(l2_reg)
        self.prefix = prefix

    @property
    def output_dim(self) -> int:
        return self.hidden_units[-1]

    def init(self, generator, device=None) -> dict:
        dims = (self.input_dim,) + self.hidden_units
        keys = split_rng(generator, len(self.hidden_units))
        params = {}
        for i in range(len(self.hidden_units)):
            params[f"{self.prefix}layer_{i}_weights"] = glorot_normal(
                keys[i], (dims[i], dims[i + 1]), device=device)
            params[f"{self.prefix}layer_{i}_bias"] = torch.zeros(
                (dims[i + 1],), dtype=torch.float32, device=device)
        return params

    def apply(self, params, x, training=False, generator=None) -> torch.Tensor:
        for i in range(len(self.hidden_units)):
            x = self.activation(x @ params[f"{self.prefix}layer_{i}_weights"]
                                + params[f"{self.prefix}layer_{i}_bias"])
            x = dropout(generator, x, self.dropout_keep[i], training)
        return x

    def l2(self, params):
        if self.l2_reg == 0.0:
            return 0.0
        total = 0.0
        for i in range(len(self.hidden_units)):
            total = total + l2_loss(params[f"{self.prefix}layer_{i}_weights"])
        return self.l2_reg * total


class FeatureSelectionGate:
    """Element weights in (0, 2) over the flat embeddings. Params
    ``{prefix}gate_w1``, ``gate_b1``, ``gate_w2``, ``gate_b2`` and, context-
    free, the context vector ``{prefix}ctx`` (1, context_dim), drawn as
    0.01 * Glorot normal."""

    def __init__(self, target_dim: int, context_dim: int, hidden_dim: int, context_free: bool,
                 l2_reg: float = 0.0, prefix: str = "fs_"):
        self.target_dim = int(target_dim)
        self.context_dim = int(context_dim)
        self.hidden_dim = int(hidden_dim)
        self.context_free = bool(context_free)
        self.l2_reg = float(l2_reg)
        self.prefix = prefix

    def init(self, generator, device=None) -> dict:
        k_ctx, k1, k2 = split_rng(generator, 3)
        p = self.prefix
        params = {
            f"{p}gate_w1": glorot_normal(k1, (self.context_dim, self.hidden_dim), device=device),
            f"{p}gate_b1": torch.zeros((self.hidden_dim,), dtype=torch.float32, device=device),
            f"{p}gate_w2": glorot_normal(k2, (self.hidden_dim, self.target_dim), device=device),
            f"{p}gate_b2": torch.zeros((self.target_dim,), dtype=torch.float32, device=device),
        }
        if self.context_free:
            params[f"{p}ctx"] = 0.01 * glorot_normal(k_ctx, (1, self.context_dim), device=device)
        return params

    def gate(self, params, context=None) -> torch.Tensor:
        """-> (1 or B, target_dim) weights in (0, 2)."""
        p = self.prefix
        ctx = params[f"{p}ctx"] if self.context_free else context
        assert ctx is not None and ctx.dim() == 2
        h = torch.relu(ctx @ params[f"{p}gate_w1"] + params[f"{p}gate_b1"])
        logits = h @ params[f"{p}gate_w2"] + params[f"{p}gate_b2"]
        return 2.0 * torch.reciprocal(1.0 + torch.exp(-logits))

    def apply(self, params, flat_embeds, context=None) -> torch.Tensor:
        return flat_embeds * self.gate(params, context)

    def l2(self, params):
        if self.l2_reg == 0.0:
            return 0.0
        return self.l2_reg * (l2_loss(params[f"{self.prefix}gate_w1"])
                              + l2_loss(params[f"{self.prefix}gate_w2"]))


class InteractionAggregation:
    """Two stream outputs -> a (B, 1) logit. Params ``{prefix}w1`` (dim1,
    1), ``w2`` (dim2, 1), ``w12`` (H, dim1/H, dim2/H), ``bias`` (1,). Both
    dims must divide by the head count."""

    def __init__(self, dim1: int, dim2: int, num_heads: int = 1, l2_reg: float = 0.0,
                 prefix: str = "agg_"):
        assert dim1 % num_heads == 0 and dim2 % num_heads == 0, (
            f"stream dims ({dim1}, {dim2}) must divide num_heads={num_heads}"
        )
        self.dim1 = int(dim1)
        self.dim2 = int(dim2)
        self.num_heads = int(num_heads)
        self.head1 = self.dim1 // self.num_heads
        self.head2 = self.dim2 // self.num_heads
        self.l2_reg = float(l2_reg)
        self.prefix = prefix

    def init(self, generator, device=None) -> dict:
        k1, k2, kw = split_rng(generator, 3)
        p = self.prefix
        return {
            f"{p}w1": glorot_normal(k1, (self.dim1, 1), device=device),
            f"{p}w2": glorot_normal(k2, (self.dim2, 1), device=device),
            f"{p}w12": glorot_normal(kw, (self.num_heads, self.head1, self.head2), device=device),
            f"{p}bias": torch.zeros((1,), dtype=torch.float32, device=device),
        }

    def apply(self, params, o1, o2) -> torch.Tensor:
        p = self.prefix
        b = o1.shape[0]
        logit = o1 @ params[f"{p}w1"] + o2 @ params[f"{p}w2"] + params[f"{p}bias"]  # (B, 1)
        h1 = o1.reshape(b, self.num_heads, self.head1)
        h2 = o2.reshape(b, self.num_heads, self.head2)
        bilinear = torch.einsum("bhi,hij,bhj->b", h1, params[f"{p}w12"], h2)
        return logit + bilinear[:, None]

    def l2(self, params):
        if self.l2_reg == 0.0:
            return 0.0
        p = self.prefix
        return self.l2_reg * (l2_loss(params[f"{p}w1"]) + l2_loss(params[f"{p}w2"])
                              + l2_loss(params[f"{p}w12"]))
