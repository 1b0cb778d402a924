"""Attentional Factorization Machine layer (arXiv:1708.04617).

Counterpart of ``recman_tpu/layers/afm.py``:

    pair_ij = e_i * e_j                      (element-wise, i < j)
    a'_ij   = h . relu(W pair_ij + b)        (attention net, factor t)
    a_ij    = softmax over the pairs
    out     = p . dropout(sum_ij a_ij pair_ij)

Plain PyTorch einsums and softmax, as the reference leaves them to XLA.
"""

from __future__ import annotations

import torch

from ..utils import glorot_normal, l2_loss, split_rng
from .common import dropout, triu_pairs


class AFMLayer:
    """Params ``afm_att_w`` (k, t), ``afm_att_b`` (t,), ``afm_att_h`` (t,)
    (drawn as (t, 1)) and ``afm_p`` (k, 1)."""

    def __init__(self, field_size, embedding_size, att_factor=4, att_dropout=1.0,
                 l2_reg=0.0, prefix=""):
        self.field_size = field_size
        self.embedding_size = embedding_size
        self.att_factor = att_factor
        self.att_dropout = att_dropout
        self.l2_reg = l2_reg
        self.prefix = prefix
        self.pairs = triu_pairs(field_size)

    def init(self, generator, device=None) -> dict:
        k, t = self.embedding_size, self.att_factor
        k1, k2, k3 = split_rng(generator, 3)
        return {
            f"{self.prefix}afm_att_w": glorot_normal(k1, (k, t), device=device),
            f"{self.prefix}afm_att_b": torch.zeros((t,), dtype=torch.float32, device=device),
            f"{self.prefix}afm_att_h": glorot_normal(k2, (t, 1), device=device).reshape(t),
            f"{self.prefix}afm_p": glorot_normal(k3, (k, 1), device=device),
        }

    def apply(self, params, embeddings, training=False, generator=None):
        assert embeddings.dim() == 3  # (B, F, k)
        pair_i, pair_j = self.pairs.on(embeddings.device)
        pairs = embeddings[:, pair_i] * embeddings[:, pair_j]
        att = torch.relu(
            torch.einsum("bpk,kt->bpt", pairs, params[f"{self.prefix}afm_att_w"])
            + params[f"{self.prefix}afm_att_b"]
        )
        scores = torch.einsum("bpt,t->bp", att, params[f"{self.prefix}afm_att_h"])
        probs = torch.softmax(scores, dim=1)
        pooled = torch.einsum("bp,bpk->bk", probs, pairs)  # (B, k)
        pooled = dropout(generator, pooled, self.att_dropout, training)
        return pooled @ params[f"{self.prefix}afm_p"]  # (B, 1)

    def l2(self, params):
        return self.l2_reg * (l2_loss(params[f"{self.prefix}afm_att_w"])
                              + l2_loss(params[f"{self.prefix}afm_p"]))
