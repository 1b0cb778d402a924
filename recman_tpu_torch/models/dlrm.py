"""DLRM, the Deep Learning Recommendation Model (arXiv:1906.00091).

Counterpart of ``recman_tpu/models/dlrm.py``: a bottom MLP projects the
dense features to the embedding width k and joins the fields as the last
one; the pairwise dot products of all fields (a (B, F, F) Gram matrix and
a static upper-triangle gather, row-major pairs) and the bottom output
feed the top MLP (``DNN`` with ``prefix="top_"``). No linear tower, as in
the paper. Without dense features there is no bottom MLP and the top MLP
reads the interactions alone.

The sparse lookups are ``EmbeddingLayer.apply``'s grouped lookup: at the
MLPerf widths on Criteo's 26 same-shape hashed tables, one K3 launch a
training step.
"""

from __future__ import annotations

import torch

from ..config import DLRMHyperParams as HP
from ..device import resolve_device
from ..layers import DNN, EmbeddingLayer, PredictionLayer, resolve_activation
from ..layers.common import triu_pairs
from ..utils import glorot_normal, l2_loss, split_rng
from .base import Model


class DLRM(Model):
    name = "dlrm"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        k = hp[HP.EmbeddingSize]

        self.embeddings = EmbeddingLayer(feat_dict, k, hp[HP.EmbeddingL2Reg], use_bias=False)
        self.n_dense = len(feat_dict.dense_feats)
        # the bottom MLP's last width is k, so that its output is a field
        self.bot_units = tuple(hp[HP.BotHiddenUnits]) + (k,) if self.n_dense else ()
        self.bot_activation = resolve_activation(hp[HP.BotActivation])
        self.bot_l2 = hp[HP.BotL2Reg]

        self.num_fields = self.embeddings.field_size + (1 if self.n_dense else 0)
        self.pairs = triu_pairs(self.num_fields)
        self.top = DNN(
            input_dim=(k if self.n_dense else 0) + len(self.pairs.indices[0]),
            hidden_units=hp[HP.TopHiddenUnits],
            dropout_keep=hp[HP.TopDropOut],
            activation=hp[HP.TopActivation],
            l2_reg=hp[HP.TopL2Reg],
            prefix="top_",
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        k_emb, k_bot, k_top = split_rng(generator, 3)
        params = {}
        params.update(self.embeddings.init(k_emb, device))
        dims = (self.n_dense,) + self.bot_units
        keys = split_rng(k_bot, max(len(self.bot_units), 1))
        for i in range(len(self.bot_units)):
            params[f"dlrm_bot_{i}_weights"] = glorot_normal(keys[i], (dims[i], dims[i + 1]),
                                                            device=device)
            params[f"dlrm_bot_{i}_bias"] = torch.zeros((dims[i + 1],), dtype=torch.float32,
                                                       device=device)
        params.update(self.top.init(k_top, device))
        params.update(self.head.init(device))
        return params

    def bottom(self, params, batch):
        """The bottom MLP over the dense features -> (B, k)."""
        x = torch.stack([batch[f.name] for f in self.feat_dict.dense_feats], dim=1)
        for i in range(len(self.bot_units)):
            x = self.bot_activation(x @ params[f"dlrm_bot_{i}_weights"]
                                    + params[f"dlrm_bot_{i}_bias"])
        return x

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        fields, _ = self.embeddings.apply(params, batch)  # (B, F, k)
        top_parts = []
        if self.n_dense:
            dense_vec = self.bottom(params, batch)
            fields = torch.cat([fields, dense_vec[:, None, :]], dim=1)
            top_parts.append(dense_vec)
        rows, cols = self.pairs.on(fields.device)
        gram = torch.einsum("bfk,bgk->bfg", fields, fields)
        top_parts.append(gram[:, rows, cols])  # (B, P)
        logit = self.top.apply(params, torch.cat(top_parts, dim=1), training=training,
                               generator=generator)
        return self.head.apply(params, logit)

    def l2(self, params):
        total = self.embeddings.l2(params) + self.top.l2(params)
        for i in range(len(self.bot_units)):
            total = total + self.bot_l2 * l2_loss(params[f"dlrm_bot_{i}_weights"])
        return total
