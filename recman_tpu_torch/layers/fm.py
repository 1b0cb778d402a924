"""Factorization Machine layers.

Counterpart of ``recman_tpu/layers/fm.py``: ``FMLayer`` (reference
recman/tf/core/layers.py:449-481) and ``FwFMLayer`` (FwFM,
arXiv:1806.03514 eq. 4). Both are plain PyTorch: the reference computes
them as XLA ops, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ..utils import l2_loss
from .common import dropout


class FMLayer:
    """FM pairwise-interaction tower over the shared field embeddings and
    their bias embeddings; parameter-free. Returns the logit (B, 1):

    - first order: dropout(keep[0]) on the bias embeddings, summed over
      the fields;
    - second order: dropout(keep[1]) on the embeddings, then the O(F*k)
      identity 0.5 * ((sum_f v)^2 - sum_f v^2), summed over k.
    """

    def __init__(self, dropout_keep=(1.0, 1.0)):
        self.dropout_keep = tuple(dropout_keep)

    def init(self, generator=None, device=None) -> dict:
        return {}

    def apply(self, params, embeddings, embedding_bias, training=False, generator=None):
        assert embeddings.dim() == 3
        bias = dropout(generator, embedding_bias, self.dropout_keep[0], training)
        y_first = bias.sum(dim=1)  # (B, 1)

        emb = dropout(generator, embeddings, self.dropout_keep[1], training)
        square_of_sum = torch.square(emb.sum(dim=1, keepdim=True))  # (B, 1, k)
        sum_of_square = torch.square(emb).sum(dim=1, keepdim=True)
        y_second = (0.5 * (square_of_sum - sum_of_square)).sum(dim=2)  # (B, 1)
        return y_first + y_second

    def l2(self, params):
        return 0.0  # reference layers.py:480-481


class FwFMLayer:
    """Field-weighted FM: sum_{i<j} r_ij <v_i, v_j> with one learned scalar
    per field pair. ``fwfm_r`` (F, F) starts at triu(ones, 1), so step 0 is
    the plain FM's pairwise term; only its upper triangle is read."""

    def __init__(self, num_fields: int, l2_reg: float = 0.0, prefix: str = "fwfm_"):
        self.num_fields = int(num_fields)
        self.l2_reg = float(l2_reg)
        self.prefix = prefix

    def init(self, generator=None, device=None) -> dict:
        ones = torch.ones((self.num_fields,) * 2, dtype=torch.float32, device=device)
        return {f"{self.prefix}r": torch.triu(ones, diagonal=1)}

    def apply(self, params, embeddings) -> torch.Tensor:
        assert embeddings.dim() == 3
        gram = torch.einsum("bfk,bgk->bfg", embeddings, embeddings)
        mask = torch.triu(torch.ones((self.num_fields,) * 2, dtype=embeddings.dtype,
                                     device=embeddings.device), diagonal=1)
        r = params[f"{self.prefix}r"] * mask
        return (gram * r[None]).sum(dim=(1, 2))[:, None]  # (B, 1)

    def l2(self, params):
        return self.l2_reg * l2_loss(params[f"{self.prefix}r"])
