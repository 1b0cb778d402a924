"""AutoInt (arXiv:1810.11921).

Counterpart of ``recman_tpu/models/autoint.py``: self-attention layers
across the field embeddings (``layers/autoint.py``); the attended fields
flatten into one logit, summed with the optional linear tower (the packed
lookup). Dense features join as extra fields through the paper's
numeric-field embeddings e_m = v_m x_m (``autoint_dense_embed``, (n_dense,
k)).
"""

from __future__ import annotations

import torch

from ..config import AutoIntHyperParams as HP
from ..device import resolve_device
from ..layers import (
    EmbeddingLayer,
    InteractingLayer,
    LinearLayer,
    PackedEmbeddingLinear,
    PredictionLayer,
)
from ..utils import glorot_normal, l2_loss, split_rng
from .base import Model


class AutoInt(Model):
    name = "autoint"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        self.use_linear = bool(hp[HP.UseLinear])
        k = hp[HP.EmbeddingSize]

        self.embeddings = EmbeddingLayer(feat_dict, k, hp[HP.EmbeddingL2Reg], use_bias=False)
        if self.use_linear:
            self.linear = LinearLayer(
                feat_dict.linear_features(hp[HP.LinearFeatures]), hp[HP.LinearL2Reg]
            )
            self.packed = PackedEmbeddingLinear(self.embeddings, self.linear)
        self.n_dense = len(feat_dict.dense_feats)
        self.num_fields = self.embeddings.field_size + self.n_dense
        self.interacting = InteractingLayer(
            input_dim=k,
            num_layers=hp[HP.AttLayerNum],
            num_heads=hp[HP.AttHeadNum],
            head_size=hp[HP.AttHeadSize],
            use_residual=hp[HP.AttUseResidual],
            dropout_keep=hp[HP.AttDropOut],
            l2_reg=hp[HP.AttL2Reg],
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        k_emb, k_att, k_dense, k_out = split_rng(generator, 4)
        params = {}
        params.update(self.embeddings.init(k_emb, device))
        if self.use_linear:
            params.update(self.linear.init(device))
        params.update(self.interacting.init(k_att, device))
        if self.n_dense:
            params["autoint_dense_embed"] = glorot_normal(
                k_dense, (self.n_dense, self.hparams[HP.EmbeddingSize]), device=device)
        params["autoint_out_w"] = glorot_normal(
            k_out, (self.num_fields * self.interacting.output_dim, 1), device=device)
        params["autoint_out_w0"] = torch.zeros((1,), dtype=torch.float32, device=device)
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        if self.use_linear:
            feat_embeds, _, linear_logit = self.packed.apply(
                params, batch, training=training, override=linear_override
            )
        else:
            feat_embeds, _ = self.embeddings.apply(params, batch)
            linear_logit = None
        fields = [feat_embeds]  # (B, F, k)
        if self.n_dense:
            dense = torch.stack([batch[f.name] for f in self.feat_dict.dense_feats], dim=1)
            fields.append(dense[:, :, None] * params["autoint_dense_embed"][None, :, :])
        att = self.interacting.apply(params, torch.cat(fields, dim=1), training=training,
                                     generator=generator)
        logit = att.reshape(att.shape[0], -1) @ params["autoint_out_w"] + params["autoint_out_w0"]
        if linear_logit is not None:
            logit = linear_logit + logit
        return self.head.apply(params, logit)

    def l2(self, params):
        total = self.embeddings.l2(params) + self.interacting.l2(params)
        total = total + self.interacting.l2_reg * l2_loss(params["autoint_out_w"])
        if self.use_linear:
            total = total + self.linear.l2(params)
        return total
