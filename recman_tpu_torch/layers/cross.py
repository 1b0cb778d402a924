"""CrossNet, the Deep & Cross Network's cross tower (arXiv:1708.05123).

Counterpart of ``recman_tpu/layers/cross.py``:

    x_{l+1} = x_0 * (x_l . w_l) + b_l + x_l        (w_l, b_l in R^d)

then a 1-logit head, so that the tower adds to the linear and DNN
towers. Plain PyTorch: each layer is a rank-1 update, O(B*d).
"""

from __future__ import annotations

import torch

from ..utils import glorot_normal, l2_loss, split_rng


class CrossNet:
    """Params ``cross_w_{i}`` (d,), ``cross_b_{i}`` (d,), the head
    ``cross_w`` (d, 1) and ``cross_w0`` (1,). ``cross_w_{i}`` is stored
    1-D but drawn as a (d, 1) matrix, at that shape's Glorot fans, as the
    reference draws it."""

    def __init__(self, input_dim, num_layers=3, l2_reg=0.0, prefix=""):
        assert num_layers > 0
        self.input_dim = input_dim
        self.num_layers = num_layers
        self.l2_reg = l2_reg
        self.prefix = prefix

    def init(self, generator, device=None) -> dict:
        d = self.input_dim
        keys = split_rng(generator, self.num_layers + 1)
        params = {}
        for i in range(self.num_layers):
            params[f"{self.prefix}cross_w_{i}"] = glorot_normal(
                keys[i], (d, 1), device=device).reshape(d)
            params[f"{self.prefix}cross_b_{i}"] = torch.zeros(
                (d,), dtype=torch.float32, device=device)
        params[f"{self.prefix}cross_w"] = glorot_normal(keys[-1], (d, 1), device=device)
        params[f"{self.prefix}cross_w0"] = torch.zeros((1,), dtype=torch.float32, device=device)
        return params

    def apply(self, params, inputs, training=False, generator=None):
        assert inputs.dim() == 2  # (B, d)
        x0 = x = inputs
        for i in range(self.num_layers):
            w = params[f"{self.prefix}cross_w_{i}"]
            b = params[f"{self.prefix}cross_b_{i}"]
            x = x0 * (x @ w)[:, None] + b + x
        return x @ params[f"{self.prefix}cross_w"] + params[f"{self.prefix}cross_w0"]

    def l2(self, params):
        """The head and every layer's weight, no bias."""
        total = self.l2_reg * l2_loss(params[f"{self.prefix}cross_w"])
        for i in range(self.num_layers):
            total = total + self.l2_reg * l2_loss(params[f"{self.prefix}cross_w_{i}"])
        return total
