"""Masked transformer encoder layer for BST (arXiv:1905.06874).

Counterpart of ``recman_tpu/layers/bst.py``: an encoder block with
LayerNorm after each residual add, key masking for padded positions, an
output projection and a pointwise FFN:

    a = MHA(x, mask);       x = LN1(x + dropout(a))
    f = W2 φ(W1 x + b1)+b2; x = LN2(x + dropout(f))

The attention is written out (einsum, softmax), as in the reference, so
that -1e9 is added to the scores of padded KEYS exactly as there.
"""

from __future__ import annotations

import math

import torch

from ..utils import glorot_normal, l2_loss, split_rng
from .common import dropout, resolve_activation
from .masknet import LayerNorm

_NEG_INF = -1e9


class TransformerEncoderLayer:
    """(B, S, k), key mask (B, S) -> (B, S, k)."""

    def __init__(self, model_dim: int, num_heads: int = 2, ff_hidden: int = 32,
                 dropout_keep: float = 1.0, activation: str = "leaky_relu",
                 l2_reg: float = 0.0, prefix: str = "bst_"):
        assert model_dim % num_heads == 0, (
            f"model_dim={model_dim} must divide num_heads={num_heads}"
        )
        self.model_dim = int(model_dim)
        self.num_heads = int(num_heads)
        self.head_dim = self.model_dim // self.num_heads
        self.ff_hidden = int(ff_hidden)
        self.dropout_keep = float(dropout_keep)
        self.activation = resolve_activation(activation)
        self.l2_reg = float(l2_reg)
        self.prefix = prefix
        self.ln1 = LayerNorm(self.model_dim, prefix=f"{prefix}att_")
        self.ln2 = LayerNorm(self.model_dim, prefix=f"{prefix}ffn_")

    def _w_names(self):
        return [f"{self.prefix}{n}" for n in ("wq", "wk", "wv", "wo", "ff_w1", "ff_w2")]

    def init(self, generator, device=None) -> dict:
        d, ff = self.model_dim, self.ff_hidden
        shapes = [(d, d), (d, d), (d, d), (d, d), (d, ff), (ff, d)]
        keys = split_rng(generator, len(shapes))
        params = {name: glorot_normal(k, shape, device=device)
                  for name, k, shape in zip(self._w_names(), keys, shapes)}
        params[f"{self.prefix}ff_b1"] = torch.zeros((ff,), dtype=torch.float32, device=device)
        params[f"{self.prefix}ff_b2"] = torch.zeros((d,), dtype=torch.float32, device=device)
        params.update(self.ln1.init(device))
        params.update(self.ln2.init(device))
        return params

    def apply(self, params, x, mask, training=False, generator=None) -> torch.Tensor:
        assert x.dim() == 3 and mask.dim() == 2
        b, s, d = x.shape
        h, dh = self.num_heads, self.head_dim
        q = (x @ params[f"{self.prefix}wq"]).reshape(b, s, h, dh)
        k = (x @ params[f"{self.prefix}wk"]).reshape(b, s, h, dh)
        v = (x @ params[f"{self.prefix}wv"]).reshape(b, s, h, dh)
        scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(dh)
        # padded KEYS receive no attention mass from anyone
        scores = scores + torch.where(mask, 0.0, _NEG_INF)[:, None, None, :]
        att = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhst,bthd->bshd", att, v).reshape(b, s, d)
        out = out @ params[f"{self.prefix}wo"]
        x = self.ln1.apply(params, x + dropout(generator, out, self.dropout_keep, training))

        f = self.activation(
            x @ params[f"{self.prefix}ff_w1"] + params[f"{self.prefix}ff_b1"]
        ) @ params[f"{self.prefix}ff_w2"] + params[f"{self.prefix}ff_b2"]
        return self.ln2.apply(params, x + dropout(generator, f, self.dropout_keep, training))

    def l2(self, params):
        if self.l2_reg == 0.0:
            return 0.0
        return self.l2_reg * sum(l2_loss(params[n]) for n in self._w_names())
