"""Row-wise Adam for embedding tables.

Counterpart of ``recman_tpu/training/rowwise_adam.py``: one second-moment
scalar per embedding ROW (DLRM's row-wise AdaGrad, Adafactor's factored
second moment), since a row's gradient exists only when its id was in
the batch, and the first moment stored in bfloat16. ``rowwise_adam``
partitions a flat name-keyed param dict: 2-D ``*_feat_embed`` tables get
the row-wise scaling, every other param exact Adam.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .train_step import (
    B1,
    B2,
    EPS,
    MASKED,
    Adam,
    MultiTransform,
    _bias_correction,
    _lr_scale,
    _scale,
    _tmap,
    _zero_count,
)


class ScaleByRowwiseAdamState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: dict  # first moment, param-shaped (bf16 by default)
    nu: dict  # second moment, (V,) for a 2-D param


class ScaleByRowwiseAdam:
    """Adam's scaling with a row-wise second moment for 2-D params, then
    -lr unless ``learning_rate`` is None (the reference's chain of
    ``scale_by_rowwise_adam`` and ``scale_by_learning_rate``; one count
    serves both).

    For a (V, k) param nu is (V,), updated with the row mean of g**2, and
    the row's denominator sqrt(nu_hat[v]) + eps scales the whole row. A 1-D
    param is exact elementwise Adam."""

    def __init__(self, learning_rate, b1=B1, b2=B2, eps=EPS, mu_dtype=torch.bfloat16):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.mu_dtype = b1, b2, eps, mu_dtype

    def init(self, params: dict) -> ScaleByRowwiseAdamState:
        return ScaleByRowwiseAdamState(
            count=_zero_count(),
            mu=_tmap(lambda p: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype), params),
            nu=_tmap(lambda p: torch.zeros(p.shape[:1] if p.dim() == 2 else p.shape,
                                           dtype=p.dtype, device=p.device), params),
        )

    def update(self, grads: dict, state: ScaleByRowwiseAdamState, params=None):
        del params
        lr = None if self.learning_rate is None else _lr_scale(self.learning_rate, state.count)
        count = state.count + 1
        bc1, bc2 = _bias_correction(self.b1, count), _bias_correction(self.b2, count)
        b1, b2 = self.b1, self.b2
        steps, mu, nu = {}, {}, {}
        for name, g in grads.items():
            if g is MASKED:
                steps[name], mu[name], nu[name] = MASKED, state.mu[name], state.nu[name]
                continue
            m_old = state.mu[name]
            mu_new = b1 * m_old.to(g.dtype) + (1.0 - b1) * g
            g2 = (g * g).mean(dim=1) if g.dim() == 2 else g * g
            nu[name] = b2 * state.nu[name] + (1.0 - b2) * g2
            denom = torch.sqrt(nu[name] / bc2) + self.eps
            if g.dim() == 2:
                denom = denom[:, None]
            steps[name] = (mu_new / bc1) / denom
            mu[name] = mu_new.to(m_old.dtype)
        if lr is not None:
            steps = _scale(steps, lr)
        return steps, ScaleByRowwiseAdamState(count, mu, nu)


def _is_table(name: str, param) -> bool:
    return name.endswith("_feat_embed") and param is not MASKED and param.dim() == 2


def scale_by_rowwise_adam(b1=B1, b2=B2, eps=EPS, mu_dtype=torch.bfloat16):
    """The reference's ``scale_by_rowwise_adam``: the row-wise scaling
    alone, with no learning rate."""
    return ScaleByRowwiseAdam(None, b1, b2, eps, mu_dtype)


def rowwise_adam(learning_rate, b1=B1, b2=B2, eps=EPS, mu_dtype=torch.bfloat16):
    """Embedding tables -> row-wise, bf16-m Adam; everything else -> exact
    Adam. A float or a schedule learning rate. A stacked (T, V, k) table
    leaf is 3-D, so it is no table here and takes exact Adam, as in the
    reference."""
    return MultiTransform(
        {"table": ScaleByRowwiseAdam(learning_rate, b1, b2, eps, mu_dtype),
         "rest": Adam(learning_rate, b1=b1, b2=b2, eps=eps)},
        lambda params: {name: "table" if _is_table(name, p) else "rest"
                        for name, p in params.items()},
    )
