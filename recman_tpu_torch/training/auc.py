"""Streaming AUC for evaluation at scale.

Counterpart of ``recman_tpu/training/auc.py`` (:19-95), with torch in
place of jax: the thresholded estimator (the approach of
``tf.keras.metrics.AUC``). TP/FP counts accumulate at ``num_buckets``
score buckets, then the ROC curve is trapezoid-integrated. The state is a
(2, num_buckets) float32 tensor, row 0 the positive counts and row 1 the
negatives; states of several shards merge by addition.
"""

from __future__ import annotations

import torch


def init_state(num_buckets: int = 2048, device=None) -> torch.Tensor:
    """(2, num_buckets) float32 zeros."""
    return torch.zeros((2, num_buckets), dtype=torch.float32, device=device)


def update(state, y_true, y_pred, weights=None, num_buckets: int = 2048) -> torch.Tensor:
    """Accumulate a batch of probabilities into the histogram state."""
    y_true = torch.as_tensor(y_true, dtype=torch.float32, device=state.device)
    y_pred = torch.as_tensor(y_pred, dtype=torch.float32, device=state.device)
    bucket = (y_pred * num_buckets).to(torch.int32).clamp(0, num_buckets - 1).long()
    w = torch.ones_like(y_pred) if weights is None else \
        torch.as_tensor(weights, dtype=torch.float32, device=state.device)
    pos = torch.zeros(num_buckets, dtype=torch.float32, device=state.device)
    neg = torch.zeros_like(pos)
    pos.index_add_(0, bucket, w * y_true)
    neg.index_add_(0, bucket, w * (1.0 - y_true))
    return state + torch.stack([pos, neg])


def merge(*states) -> torch.Tensor:
    """Combine shard states (an all-reduce in data-parallel settings)."""
    out = states[0]
    for s in states[1:]:
        out = out + s
    return out


def compute(state) -> torch.Tensor:
    """Trapezoidal AUC from the accumulated histograms."""
    pos, neg = state[0], state[1]
    # descending-threshold cumulative sums -> ROC points
    tp = torch.cumsum(pos.flip(0), 0)
    fp = torch.cumsum(neg.flip(0), 0)
    zero = torch.zeros(1, dtype=state.dtype, device=state.device)
    tpr = torch.cat([zero, tp / tp[-1].clamp_min(1.0)])
    fpr = torch.cat([zero, fp / fp[-1].clamp_min(1.0)])
    return torch.sum((fpr[1:] - fpr[:-1]) * 0.5 * (tpr[1:] + tpr[:-1]))


class StreamingAUC:
    """Metric-protocol wrapper (higher_the_better) around the functional
    API: a drop-in for RocAucScore when predictions do not fit on the host,
    with update/result for incremental use from an eval loop."""

    def __init__(self, num_buckets: int = 2048):
        self.num_buckets = num_buckets
        self.reset()

    def reset(self):
        self._state = init_state(self.num_buckets)

    def update(self, y_true, y_pred, weights=None):
        self._state = update(self._state, y_true, y_pred, weights, num_buckets=self.num_buckets)

    def result(self) -> float:
        return float(compute(self._state))

    def __call__(self, y_true, y_pred):
        self.reset()
        self.update(y_true, y_pred)
        return self.result()

    def __str__(self):
        return "roc_auc"

    __repr__ = __str__

    @property
    def higher_the_better(self):
        return True
