"""InteractingLayer, AutoInt's multi-head self-attention across fields
(arXiv:1810.11921).

Counterpart of ``recman_tpu/layers/autoint.py``. Each layer projects the
(B, F, d) fields to per-head queries, keys and values, attends across
the F fields with the paper's unscaled dot product (softmax of q . k, no
1/sqrt(dh): not ``scaled_dot_product_attention``'s default), concatenates
the heads and adds a projected residual before a ReLU. Plain PyTorch
batched matmuls.
"""

from __future__ import annotations

import torch

from ..utils import glorot_normal, l2_loss, split_rng
from .common import dropout


class InteractingLayer:
    """Params per layer i: ``autoint_{i}_wq``, ``_wk``, ``_wv`` (d_in,
    H*dh) and, with ``use_residual``, ``autoint_{i}_wres``. Every layer
    outputs H*dh per field."""

    def __init__(self, input_dim, num_layers=3, num_heads=2, head_size=8,
                 use_residual=True, dropout_keep=1.0, l2_reg=0.0, prefix=""):
        assert num_layers > 0 and num_heads > 0 and head_size > 0
        self.input_dim = input_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_size = head_size
        self.use_residual = use_residual
        self.dropout_keep = dropout_keep
        self.l2_reg = l2_reg
        self.prefix = prefix
        self.output_dim = num_heads * head_size

    def _names(self, i):
        names = [f"{self.prefix}autoint_{i}_w{x}" for x in ("q", "k", "v")]
        if self.use_residual:
            names.append(f"{self.prefix}autoint_{i}_wres")
        return names

    def init(self, generator, device=None) -> dict:
        """4 keys a layer, taken in order whether or not the residual is
        there (without it, layer 1 starts at key 3), as the reference."""
        keys = iter(split_rng(generator, self.num_layers * 4))
        params = {}
        d_in = self.input_dim
        for i in range(self.num_layers):
            for name in self._names(i):
                params[name] = glorot_normal(next(keys), (d_in, self.output_dim), device=device)
            d_in = self.output_dim
        return params

    def apply(self, params, inputs, training=False, generator=None):
        """(B, F, d_in) -> (B, F, H*dh) after num_layers rounds."""
        assert inputs.dim() == 3
        h, dh = self.num_heads, self.head_size
        x = inputs
        for i in range(self.num_layers):
            b, f, _ = x.shape

            def heads(w):  # (B, F, H*dh) -> (B, H, F, dh)
                return (x @ params[f"{self.prefix}autoint_{i}_{w}"]).reshape(
                    b, f, h, dh).transpose(1, 2)

            q, k, v = heads("wq"), heads("wk"), heads("wv")
            att = torch.softmax(torch.einsum("bhfd,bhgd->bhfg", q, k), dim=-1)
            att = dropout(generator, att, self.dropout_keep, training)
            out = torch.einsum("bhfg,bhgd->bhfd", att, v).transpose(1, 2).reshape(b, f, h * dh)
            if self.use_residual:
                out = out + x @ params[f"{self.prefix}autoint_{i}_wres"]
            x = torch.relu(out)
        return x

    def l2(self, params):
        total = 0.0
        for i in range(self.num_layers):
            for name in self._names(i):
                total = total + self.l2_reg * l2_loss(params[name])
        return total
