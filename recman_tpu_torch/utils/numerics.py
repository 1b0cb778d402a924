"""Loss and regularization helpers (counterpart of
``recman_tpu/utils/numerics.py:8-44``)."""

from __future__ import annotations

import torch


def l2_loss(x) -> torch.Tensor:
    """sum(x^2)/2 — tf.nn.l2_loss semantics, used by every layer's l2()."""
    return 0.5 * torch.sum(torch.square(x))


def bce_per_example(y_true, y_pred, eps=1e-7) -> torch.Tensor:
    """Per-example BCE over probabilities clipped to [eps, 1 - eps] (keras
    epsilon clipping) — BCE on probabilities, not on logits."""
    p = torch.clamp(y_pred, eps, 1.0 - eps)
    return -(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))


def mse_per_example(y_true, y_pred) -> torch.Tensor:
    return torch.square(y_true - y_pred)


def _weighted_mean(per_ex, weights):
    if weights is None:
        return torch.mean(per_ex)
    return torch.sum(per_ex * weights) / torch.clamp(torch.sum(weights), min=1.0)


def binary_cross_entropy(y_true, y_pred, weights=None, eps=1e-7) -> torch.Tensor:
    """Mean BCE; ``weights`` (0 on padded rows) makes it the weighted mean
    sum(l * w) / max(sum(w), 1)."""
    return _weighted_mean(bce_per_example(y_true, y_pred, eps), weights)


def mean_squared_error(y_true, y_pred, weights=None) -> torch.Tensor:
    """Regression loss, weighted like ``binary_cross_entropy``."""
    return _weighted_mean(mse_per_example(y_true, y_pred), weights)
