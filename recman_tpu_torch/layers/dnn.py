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

In a sharded run (``utils.sharded_run``; the row-sharded steps of
``parallel/train_pjit.py`` open it) each layer runs as its weights' spec
in the run says (``parallel.sharding.param_specs(tp_dense_threshold=)``,
Megatron's alternation over the model axis); with no run, or no spec, a
layer is the plain one. The activation between layers is either full or
a block of its columns:

- a column-sharded layer ``(None, "model")`` takes a full input through
  the run's ``copy_to_blocks`` (Megatron's f: the backward sums the
  input's cotangent over the model group) and leaves a column block;
- a row-sharded layer ``("model", None)`` takes a block (it slices a full
  input with ``block_of``) and a sum over the model axis follows
  (``reduce_blocks``, Megatron's g, its backward the pass-through);
- a replicated layer, and the head, gather a blocked input whole first.

A replicated leaf that a rank reads only a block of (a column layer's bias
below the threshold, its Dice ``alpha``, ``mean`` and ``var``) is sliced
by ``block_of``, whose backward all-gathers the blocks' cotangents, so its
gradient is whole and equal on every model rank; captured moments are
gathered whole. Dropout on a block draws the full-width mask from the
generator and slices it, the mask a replicated run draws.
"""

from __future__ import annotations

import torch

from ..utils import compute_hidden_units_s2, glorot_normal, l2_loss, split_rng
from ..utils.sharded_run import current_run
from .common import apply_dice, apply_mask, dice_params, dropout, dropout_mask, resolve_activation

_COLUMN = (None, "model")
_ROW = ("model", None)


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
        {moment param name: the batch's moment} (``Trainer.calibrate``).
        In a sharded run each layer runs as its spec says (the module
        docstring)."""
        assert inputs.dim() == 2
        run = current_run()
        specs = run.specs if run is not None else {}
        p = self.prefix
        y = dropout(generator, inputs, self.dropout_keep[0], training)
        blocked = False
        for i in range(len(self.hidden_units)):
            w, b = params[f"{p}dnn_layer_{i}_weights"], params[f"{p}dnn_layer_{i}_bias"]
            spec = specs.get(f"{p}dnn_layer_{i}_weights", ())
            if spec == _COLUMN:
                if blocked:
                    y = run.gather_blocks(y, 1)
                y = run.copy_to_blocks(y) @ w
                y = y + (b if specs.get(f"{p}dnn_layer_{i}_bias") else run.block_of(b, 0))
                blocked = True
            elif spec == _ROW:
                if not blocked:
                    y = run.block_of(y, 1)
                y = run.reduce_blocks(y @ w) + b
                blocked = False
            else:
                if blocked:
                    y = run.gather_blocks(y, 1)
                    blocked = False
                y = y @ w + b
            if self.use_dice:
                y = self._dice(params, i, y, training, moment_capture, run if blocked else None)
            else:
                y = self.activation(y)
            keep = self.dropout_keep[i + 1]
            if blocked:
                n = y.shape[1]
                mask = dropout_mask(generator, (y.shape[0], n * run.model_n), y.device, keep,
                                    training)
                if mask is not None:
                    mask = mask[:, run.model_index * n:(run.model_index + 1) * n]
                y = apply_mask(y, mask, keep)
            else:
                y = dropout(generator, y, keep, training)
        if blocked:
            y = run.gather_blocks(y, 1)
        return y @ params[f"{p}dnn_w"] + params[f"{p}dnn_w0"]

    def _dice(self, params, i, y, training, moment_capture, run):
        """Dice of layer ``i`` on a full activation, or (given the ``run``) on
        a column block of it: a block reads its units' slice of the
        replicated Dice params, and its captured moments are gathered
        whole."""
        prefix = f"{self.prefix}dnn_dice"
        if run is None:
            return apply_dice(params, prefix, i, y, training, moment_capture)
        names = [f"{prefix}_{kind}_{i}" for kind in ("alpha", "mean", "var")]
        local = {k: run.block_of(params[k], 0) for k in names}
        captured = {} if moment_capture is not None else None
        y = apply_dice(local, prefix, i, y, training, captured)
        if captured:
            moment_capture.update({k: run.gather_blocks(v, 0) for k, v in captured.items()})
        return y

    def l2(self, params):
        """Layer weights + head, no biases (reference layers.py:611-628)."""
        total = self.l2_reg * l2_loss(params[f"{self.prefix}dnn_w"])
        for i in range(len(self.hidden_units)):
            total = total + self.l2_reg * l2_loss(
                params[f"{self.prefix}dnn_layer_{i}_weights"]
            )
        return total
