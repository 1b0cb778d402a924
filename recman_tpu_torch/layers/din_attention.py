"""Attention Sequence Pooling for DIN (arXiv:1706.06978).

Counterpart of ``recman_tpu/layers/din_attention.py``:

    query  = candidate item embedding                (B, k)
    keys   = behavior-sequence embeddings            (B, L, k)
    att(q, k_t) = MLP([q, k_t, q - k_t, q * k_t])    per position
    pooled = sum_t w_t * k_t                         (B, k)

Padding positions (ids < 0) are masked. ``weight_normalization`` takes a
softmax over the positions with -1e9 at the masked ones; otherwise the
raw scores, zeroed where masked, scale the keys. With Dice the moments
are over all B·L positions, padding included, as in the reference.
"""

from __future__ import annotations

import torch

from ..utils import glorot_normal, l2_loss, split_rng
from .common import apply_dice, dice_params, resolve_activation

_NEG_INF = -1e9


class ASPLayer:
    """Params: ``asp_layer_{i}_weights/bias`` per attention MLP layer,
    ``asp_w``/``asp_w0`` head, and with Dice ``asp_dice_alpha_{i}`` and
    the frozen inference moments ``asp_dice_mean_{i}``/``asp_dice_var_{i}``
    (written by ``Trainer.calibrate``)."""

    def __init__(self, embedding_size, att_hidden_units=(80, 40), activation="dice",
                 weight_normalization=False, l2_reg=0.0, prefix=""):
        self.embedding_size = embedding_size
        self.att_hidden_units = tuple(att_hidden_units)
        self.use_dice = activation == "dice"
        self.activation = None if self.use_dice else resolve_activation(activation)
        self.weight_normalization = weight_normalization
        self.l2_reg = l2_reg
        self.prefix = prefix

    def init(self, generator, device=None) -> dict:
        dims = (4 * self.embedding_size,) + self.att_hidden_units
        keys = split_rng(generator, len(self.att_hidden_units) + 1)
        params = {}
        for i in range(len(self.att_hidden_units)):
            params[f"{self.prefix}asp_layer_{i}_weights"] = glorot_normal(
                keys[i], (dims[i], dims[i + 1]), device=device
            )
            params[f"{self.prefix}asp_layer_{i}_bias"] = torch.zeros(
                (dims[i + 1],), dtype=torch.float32, device=device
            )
            if self.use_dice:
                params.update(dice_params(f"{self.prefix}asp_dice", i, dims[i + 1], device))
        params[f"{self.prefix}asp_w"] = glorot_normal(keys[-1], (dims[-1], 1), device=device)
        params[f"{self.prefix}asp_w0"] = torch.zeros((1,), dtype=torch.float32, device=device)
        return params

    def apply(self, params, queries, keys, key_mask, training=False, moment_capture=None):
        """queries (B, k); keys (B, L, k); key_mask (B, L) bool -> (B, k).
        ``moment_capture`` as in ``DNN.apply``."""
        b, l, k = keys.shape
        q = queries[:, None, :].expand(b, l, k)
        x = torch.cat([q, keys, q - keys, q * keys], dim=-1).reshape(b * l, 4 * k)
        for i in range(len(self.att_hidden_units)):
            x = (x @ params[f"{self.prefix}asp_layer_{i}_weights"]
                 + params[f"{self.prefix}asp_layer_{i}_bias"])
            if self.use_dice:
                x = apply_dice(params, f"{self.prefix}asp_dice", i, x, training, moment_capture)
            else:
                x = self.activation(x)
        scores = (x @ params[f"{self.prefix}asp_w"] + params[f"{self.prefix}asp_w0"]).reshape(b, l)

        if self.weight_normalization:
            scores = torch.where(key_mask, scores, _NEG_INF)
            weights = torch.exp(scores - scores.max(dim=1, keepdim=True).values)
            weights = weights / weights.sum(dim=1, keepdim=True).clamp_min(1e-9)
        else:
            weights = torch.where(key_mask, scores, 0.0)
        return torch.einsum("bl,blk->bk", weights, keys)

    def l2(self, params):
        total = self.l2_reg * l2_loss(params[f"{self.prefix}asp_w"])
        for i in range(len(self.att_hidden_units)):
            total = total + self.l2_reg * l2_loss(params[f"{self.prefix}asp_layer_{i}_weights"])
        return total
