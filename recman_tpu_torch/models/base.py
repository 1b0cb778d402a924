"""Model base: the init/apply/loss contract of ``recman_tpu/models/base.py``.

A model owns static structure (feature schema + hparams) and exposes

    init_params(generator, device=None)                  -> flat {name: tensor}
    apply(params, batch, training=False, generator=None, ...) -> (B,) predictions
    loss(params, batch, training=True, generator=None, weights=None) -> scalar

Parameter names and shapes are the reference's, so a JAX param dict
carried over by ``convert.params_from_jax`` loads as it is. ``generator``
draws the dropout masks in training; it cannot reproduce the reference's
``jax.random`` bits.
"""

from __future__ import annotations

from ..features import FeatureSet
from ..utils import binary_cross_entropy, mean_squared_error


class Model:
    """Base for the ported models."""

    name = "model"

    def __init__(self, feat_dict: FeatureSet, task="classification"):
        assert task in ("classification", "regression")
        self.feat_dict = feat_dict
        self.task = task

    def init_params(self, generator, device=None) -> dict:
        raise NotImplementedError

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        raise NotImplementedError

    def l2(self, params):
        raise NotImplementedError

    def data_loss(self, y_true, y_pred, weights=None):
        """BCE on probabilities / MSE by task (reference utils.py:192-198)."""
        if self.task == "classification":
            return binary_cross_entropy(y_true, y_pred, weights)
        return mean_squared_error(y_true, y_pred, weights)

    def loss(self, params, batch, training=True, generator=None, weights=None):
        """Data loss + sum of the layer L2s (reference base.py:52-61)."""
        preds = self.apply(params, batch, training=training, generator=generator)
        return self.data_loss(batch["y"], preds, weights) + self.l2(params)

    def dense_columns(self, batch) -> list:
        """Dense inputs in schema order as (B, 1) columns."""
        return [batch[f.name][:, None] for f in self.feat_dict.dense_feats]
