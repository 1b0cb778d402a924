"""Model base: the init/apply/loss contract of ``recman_tpu/models/base.py``.

A model owns static structure (feature schema + hparams) and exposes

    init_params(generator, device=None)                  -> flat {name: tensor}
    apply(params, batch, training=False, generator=None, ...) -> (B,) predictions
    loss(params, batch, training=True, generator=None, weights=None) -> scalar

Parameter names and shapes are the reference's, so a JAX param dict
carried over by ``convert.params_from_jax`` loads as it is. A
``utils.JaxKey`` in ``init_params``'s generator's place draws the
reference's initial params for that key. ``generator`` draws the dropout
masks in training; it cannot reproduce the reference's ``jax.random``
bits.
"""

from __future__ import annotations

import torch

from ..features import FeatureSet
from ..obs.trace import span
from ..utils import binary_cross_entropy, mean_squared_error
from ..utils.numerics import bce_per_example, mse_per_example


class OneRank:
    """How ``Model.rank_loss`` sees a batch split over ranks whose loss
    shares are summed: here one rank holds the whole batch.
    ``parallel.train_pjit.DataSplit`` is the data group's form."""

    ranks = 1

    def total(self, x):
        """The sum of ``x`` over the ranks (no gradient flows through it)."""
        return x

    def roll(self, x):
        """``torch.roll(x, 1, dims=0)`` over the ranks' rows in order."""
        return torch.roll(x, 1, dims=0)


ONE_RANK = OneRank()


class Model:
    """Base for the ported models."""

    name = "model"
    # models that need a SequenceFeat (the DIN family) set this, so that a
    # generic runner (examples/model_zoo_ml.py) can tell them apart
    requires_sequence = False
    # models whose apply() takes moment_capture (Dice's batch moments,
    # Trainer.calibrate) set this
    supports_moment_capture = False

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
        data = self.data_loss(batch["y"], preds, weights)
        with span("train.l2"):
            l2 = self.l2(params)
        return data + l2

    def rank_loss(self, params, batch, weights, split=ONE_RANK, training=True, generator=None):
        """This rank's share of ``loss`` when the batch's rows are split over
        ``split.ranks`` ranks whose shares are summed (the row-sharded steps
        of ``parallel/train_pjit.py``): the weighted data loss of its rows
        over the weights' global sum, plus L2 / ranks. The shares add up to
        ``loss`` on the whole batch. A model whose ``loss`` adds another
        term overrides this with that term's share (``DIEN``)."""
        preds = self.apply(params, batch, training=training, generator=generator)
        data = self.data_share(batch["y"], preds, weights, split)
        with span("train.l2"):
            l2 = self.l2(params) / split.ranks
        return data + l2

    def data_share(self, y_true, y_pred, weights, split=ONE_RANK):
        """sum(w * per-example loss) of these rows over the global sum of the
        weights (at least 1), as ``data_loss`` weights the whole batch."""
        per_ex = (bce_per_example(y_true, y_pred) if self.task == "classification"
                  else mse_per_example(y_true, y_pred))
        return torch.sum(per_ex * weights) / split.total(weights.sum()).clamp_min(1.0)

    def dense_columns(self, batch) -> list:
        """Dense inputs in schema order as (B, 1) columns."""
        return [batch[f.name][:, None] for f in self.feat_dict.dense_feats]

    @staticmethod
    def inference_dropout(keep_list):
        return tuple(1.0 for _ in keep_list)
