"""Product layer of PNN (arXiv:1611.00144).

Counterpart of ``recman_tpu/layers/product.py``: the product signal ``p``
that PNN concatenates with the flat embeddings before its DNN.

- inner (IPNN): the F(F-1)/2 pairwise inner products <v_i, v_j>, one
  (B, F, F) Gram matrix and a static upper-triangle gather (row-major
  pairs);
- outer (OPNN, the superposition form): vec((sum_f v_f)(sum_f v_f)^T),
  (B, k*k), whose per-unit kernels the DNN's first matmul holds;
- both: inner, then outer.

Parameter-free; plain PyTorch.
"""

from __future__ import annotations

import torch

from .common import triu_pairs


class ProductLayer:
    """kind in {"inner", "outer", "both"}."""

    def __init__(self, num_fields: int, embedding_size: int, kind="inner"):
        assert kind in ("inner", "outer", "both")
        self.kind = kind
        self.num_fields = int(num_fields)
        self.embedding_size = int(embedding_size)
        self.pairs = triu_pairs(self.num_fields)
        self.n_pairs = len(self.pairs.indices[0])

    @property
    def output_dim(self) -> int:
        k2 = self.embedding_size * self.embedding_size
        return {"inner": self.n_pairs, "outer": k2, "both": self.n_pairs + k2}[self.kind]

    def init(self, generator=None, device=None) -> dict:
        return {}

    def apply(self, params, embeddings) -> torch.Tensor:
        assert embeddings.dim() == 3  # (B, F, k)
        parts = []
        if self.kind in ("inner", "both"):
            rows, cols = self.pairs.on(embeddings.device)
            gram = torch.einsum("bfk,bgk->bfg", embeddings, embeddings)
            parts.append(gram[:, rows, cols])  # (B, F(F-1)/2)
        if self.kind in ("outer", "both"):
            s = embeddings.sum(dim=1)  # (B, k)
            parts.append((s[:, :, None] * s[:, None, :]).reshape(s.shape[0], -1))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def l2(self, params):
        return 0.0
