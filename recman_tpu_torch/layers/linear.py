"""Linear (wide) tower parameters and the inference-time weight override.

Counterpart of ``recman_tpu/layers/linear.py``. ``linear_w`` is one 1-D
vector over every linear feature, each feature owning the slice that
starts at its offset; the logit terms are gathers from those slices
(layers/packed.py):

- SparseFeat        w[offset + id]                 (OOV id 0 contributes)
- SparseValueFeat   w[offset + id] * value
- MultiVal*Feat     sum over ids > 0 of w[offset + id] (OOV excluded)
- DenseFeat         w[offset] * value

The override (reference layers.py:338-345, the "penalize Outdoor by -5"
demo) is an additive vector built from ``feat.weights``, applied when
not training.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import l2_loss


class LinearLayer:
    """Params ``{prefix}linear_w`` (total_size,) and ``{prefix}linear_w0``
    (1,), both zero-initialised (reference layers.py:317-328)."""

    def __init__(self, linear_feats, l2_reg=1e-5, prefix=""):
        self.feats = list(linear_feats)
        self.l2_reg = l2_reg
        self.prefix = prefix
        self.offsets = {}
        offset = 0
        for feat in self.feats:
            self.offsets[feat.name] = offset
            offset += feat.feat_size
        self.total_size = offset

    def init(self, device=None) -> dict:
        return {
            f"{self.prefix}linear_w": torch.zeros(
                (self.total_size,), dtype=torch.float32, device=device
            ),
            f"{self.prefix}linear_w0": torch.zeros(
                (1,), dtype=torch.float32, device=device
            ),
        }

    def override_vector(self) -> np.ndarray:
        """Concat of the per-feature override vectors, aligned to linear_w."""
        return np.concatenate(
            [np.asarray(f.weights, dtype=np.float32) for f in self.feats]
        )

    def weights(self, params, override=None) -> torch.Tensor:
        """``linear_w`` plus the override (zero-padded to its length)."""
        w = params[f"{self.prefix}linear_w"]
        if override is None:
            return w
        override = override.to(device=w.device, dtype=w.dtype)
        if override.shape[0] < w.shape[0]:
            override = torch.cat(
                [override, override.new_zeros(w.shape[0] - override.shape[0])]
            )
        return w + override

    def l2(self, params):
        """Reference layers.py:349-354 / 441-446."""
        return self.l2_reg * l2_loss(params[f"{self.prefix}linear_w"])
