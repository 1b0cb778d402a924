"""SENET field reweighting and bilinear field interactions (FiBiNET,
arXiv:1905.09433).

Counterpart of ``recman_tpu/layers/senet.py``. ``SENETLayer`` squeezes
each field to its mean over k, runs a two-layer ReLU excitation over the
F scalars and rescales the fields. ``BilinearInteraction`` gives every
field pair i < j (row-major) p_ij = (v_i W) * v_j, with the paper's three
weight-sharing schemes, all one stacked (n_w, k, k) leaf:

- "all":         one shared W            (n_w = 1)
- "each":        W_i of the pair's first field i   (n_w = F)
- "interaction": W_ij of the pair        (n_w = F(F-1)/2)

Plain PyTorch: static pair gathers and one batched matmul.
"""

from __future__ import annotations

import torch

from ..utils import glorot_normal, l2_loss, split_rng
from .common import triu_pairs


class SENETLayer:
    """(B, F, k) -> (B, F, k). Params ``{prefix}w1`` (F, F // ratio, at
    least 1) and ``{prefix}w2`` (F // ratio, F)."""

    def __init__(self, num_fields: int, reduction_ratio: int = 3,
                 l2_reg: float = 0.0, prefix: str = "senet_"):
        self.num_fields = int(num_fields)
        self.reduced = max(1, self.num_fields // int(reduction_ratio))
        self.l2_reg = float(l2_reg)
        self.prefix = prefix

    def init(self, generator, device=None) -> dict:
        k1, k2 = split_rng(generator, 2)
        return {
            f"{self.prefix}w1": glorot_normal(k1, (self.num_fields, self.reduced), device=device),
            f"{self.prefix}w2": glorot_normal(k2, (self.reduced, self.num_fields), device=device),
        }

    def apply(self, params, embeddings) -> torch.Tensor:
        assert embeddings.dim() == 3
        z = embeddings.mean(dim=2)  # squeeze: (B, F)
        a = torch.relu(z @ params[f"{self.prefix}w1"])
        a = torch.relu(a @ params[f"{self.prefix}w2"])  # excitation: (B, F)
        return embeddings * a[:, :, None]

    def l2(self, params):
        return self.l2_reg * (l2_loss(params[f"{self.prefix}w1"])
                              + l2_loss(params[f"{self.prefix}w2"]))


class BilinearInteraction:
    """(B, F, k) -> (B, F(F-1)/2, k). Param ``{prefix}w_{type}`` (n_w, k,
    k), drawn as one 3-D Glorot tensor (fans k * n_w each)."""

    def __init__(self, num_fields: int, embedding_size: int, bilinear_type: str = "all",
                 l2_reg: float = 0.0, prefix: str = "bilinear_"):
        assert bilinear_type in ("all", "each", "interaction")
        self.num_fields = int(num_fields)
        self.embedding_size = int(embedding_size)
        self.bilinear_type = bilinear_type
        self.l2_reg = float(l2_reg)
        self.prefix = prefix
        self.pairs = triu_pairs(self.num_fields)
        self.n_pairs = len(self.pairs.indices[0])

    @property
    def output_dim(self) -> int:
        return self.n_pairs * self.embedding_size

    def _w_name(self):
        return f"{self.prefix}w_{self.bilinear_type}"

    def init(self, generator, device=None) -> dict:
        k = self.embedding_size
        n_w = {"all": 1, "each": self.num_fields, "interaction": self.n_pairs}[self.bilinear_type]
        return {self._w_name(): glorot_normal(generator, (n_w, k, k), device=device)}

    def apply(self, params, embeddings) -> torch.Tensor:
        assert embeddings.dim() == 3
        w = params[self._w_name()]  # (n_w, k, k)
        rows, cols = self.pairs.on(embeddings.device)
        vi = embeddings[:, rows, :]  # (B, P, k)
        vj = embeddings[:, cols, :]
        if self.bilinear_type == "all":
            left = vi @ w[0]
        else:
            w_pair = w[rows] if self.bilinear_type == "each" else w  # (P, k, k)
            left = torch.einsum("bpk,pkl->bpl", vi, w_pair)
        return left * vj

    def l2(self, params):
        return self.l2_reg * l2_loss(params[self._w_name()])
