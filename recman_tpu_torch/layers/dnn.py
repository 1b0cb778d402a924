"""MLP tower + input combiner (reference recman/tf/core/layers.py:484-628).

Counterpart of ``recman_tpu/layers/dnn.py``: keep-probability dropout on
the input (keep[0]) and after every activation (keep[i+1]) in training.
The matmuls are ``torch.matmul`` in f32, as the reference leaves them to
XLA. A hidden_units with any ``None`` entry is sized whole by the 2/3
rule (``compute_hidden_units_s2``, reference dnn.py:52-53).

``activation="dice"`` adds per-layer ``dnn_dice_alpha_{i}`` params and
the frozen inference moments ``dnn_dice_mean_{i}`` / ``dnn_dice_var_{i}``
(reference dnn.py:34-106): training normalizes with the batch's moments,
which ``moment_capture`` records (``Trainer.calibrate``), inference with
the stored ones.
"""

from __future__ import annotations

import torch

from ..utils import compute_hidden_units_s2, glorot_normal, l2_loss, split_rng
from .common import apply_dice, dice_params, dropout, resolve_activation


def dnn_combine(inputs: list) -> torch.Tensor:
    """Flatten each input to (B, -1) and concat — reference DNNCombiner
    (layers.py:484-501). Takes (B, F, k) embeddings and (B,) / (B, d)
    dense columns."""
    flat = []
    for x in inputs:
        if x.dim() == 1:
            x = x[:, None]
        flat.append(x.reshape(x.shape[0], -1))
    return torch.cat(flat, dim=1)


class DNN:
    """Plain MLP with a final 1-logit projection. Param names match the
    reference: ``dnn_layer_{i}_weights`` / ``dnn_layer_{i}_bias`` /
    ``dnn_w`` / ``dnn_w0``."""

    def __init__(self, input_dim, hidden_units, dropout_keep, activation,
                 l2_reg=1e-5, prefix=""):
        assert len(hidden_units) > 0
        assert len(hidden_units) + 1 == len(dropout_keep)
        if any(u is None for u in hidden_units):
            hidden_units = compute_hidden_units_s2(len(hidden_units), input_dim)
        self.input_dim = input_dim
        self.hidden_units = tuple(hidden_units)
        self.dropout_keep = tuple(dropout_keep)
        self.use_dice = activation == "dice"
        self.activation = None if self.use_dice else resolve_activation(activation)
        self.l2_reg = l2_reg
        self.prefix = prefix

    def init(self, generator, device=None) -> dict:
        dims = (self.input_dim,) + self.hidden_units
        keys = split_rng(generator, len(self.hidden_units) + 1)
        params = {}
        for i in range(len(self.hidden_units)):
            params[f"{self.prefix}dnn_layer_{i}_weights"] = glorot_normal(
                keys[i], (dims[i], dims[i + 1]), device=device
            )
            params[f"{self.prefix}dnn_layer_{i}_bias"] = torch.zeros(
                (dims[i + 1],), dtype=torch.float32, device=device
            )
            if self.use_dice:
                params.update(dice_params(f"{self.prefix}dnn_dice", i, dims[i + 1], device))
        params[f"{self.prefix}dnn_w"] = glorot_normal(keys[-1], (dims[-1], 1), device=device)
        params[f"{self.prefix}dnn_w0"] = torch.zeros((1,), dtype=torch.float32, device=device)
        return params

    def apply(self, params, inputs, training=False, generator=None, moment_capture=None):
        """``moment_capture``: a dict that a training forward fills with
        {moment param name: the batch's moment} (``Trainer.calibrate``)."""
        assert inputs.dim() == 2
        y = dropout(generator, inputs, self.dropout_keep[0], training)
        for i in range(len(self.hidden_units)):
            y = (
                y @ params[f"{self.prefix}dnn_layer_{i}_weights"]
                + params[f"{self.prefix}dnn_layer_{i}_bias"]
            )
            if self.use_dice:
                y = apply_dice(params, f"{self.prefix}dnn_dice", i, y, training, moment_capture)
            else:
                y = self.activation(y)
            y = dropout(generator, y, self.dropout_keep[i + 1], training)
        return y @ params[f"{self.prefix}dnn_w"] + params[f"{self.prefix}dnn_w0"]

    def l2(self, params):
        """Layer weights + head, no biases (reference layers.py:611-628)."""
        total = self.l2_reg * l2_loss(params[f"{self.prefix}dnn_w"])
        for i in range(len(self.hidden_units)):
            total = total + self.l2_reg * l2_loss(
                params[f"{self.prefix}dnn_layer_{i}_weights"]
            )
        return total
