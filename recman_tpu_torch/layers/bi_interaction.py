"""Bi-Interaction pooling (NFM, arXiv:1708.05027 eq. 4).

Counterpart of ``recman_tpu/layers/bi_interaction.py``: FM's O(F*k)
identity kept as the k-vector 0.5 * [(sum_f v_f)^2 - sum_f v_f^2], which
NFM feeds to a DNN.
"""

from __future__ import annotations

import torch

from .common import dropout


class BiInteractionPooling:
    """(B, F, k) field embeddings -> (B, k); parameter-free.
    ``dropout_keep`` is a keep probability on the pooled output."""

    def __init__(self, dropout_keep=1.0):
        self.dropout_keep = float(dropout_keep)

    def init(self, generator=None, device=None) -> dict:
        return {}

    def apply(self, params, embeddings, training=False, generator=None):
        assert embeddings.dim() == 3
        sum_emb = embeddings.sum(dim=1)  # (B, k)
        sum_sq = torch.square(embeddings).sum(dim=1)
        pooled = 0.5 * (torch.square(sum_emb) - sum_sq)
        return dropout(generator, pooled, self.dropout_keep, training)

    def l2(self, params):
        return 0.0
