"""DCN, the Deep & Cross Network (arXiv:1708.05123).

Counterpart of ``recman_tpu/models/dcn.py``: linear + DNN + CrossNet
towers over the same combined input x0 (embeddings, then the dense
columns). Each tower is summed once, as the reference documents (its
own source, a stale TF graph, added the DNN's logit twice). With
``use_linear=False`` the embeddings come from ``EmbeddingLayer.apply``.
"""

from __future__ import annotations

from ..config import DCNHyperParams as HP
from ..device import resolve_device
from ..utils import split_rng
from ..layers import (
    DNN,
    CrossNet,
    EmbeddingLayer,
    LinearLayer,
    PackedEmbeddingLinear,
    PredictionLayer,
    dnn_combine,
)
from .base import Model


class DCN(Model):
    name = "dcn"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        self.use_linear = bool(hp[HP.UseLinear])

        self.embeddings = EmbeddingLayer(
            feat_dict, hp[HP.EmbeddingSize], hp[HP.EmbeddingL2Reg], use_bias=False
        )
        if self.use_linear:
            self.linear = LinearLayer(
                feat_dict.linear_features(hp[HP.LinearFeatures]), hp[HP.LinearL2Reg]
            )
            self.packed = PackedEmbeddingLinear(self.embeddings, self.linear)
        input_dim = (
            self.embeddings.field_size * hp[HP.EmbeddingSize] + len(feat_dict.dense_feats)
        )
        self.dnn = DNN(
            input_dim=input_dim,
            hidden_units=hp[HP.DeepHiddenUnits],
            dropout_keep=hp[HP.DeepDropOut],
            activation=hp[HP.DeepActivation],
            l2_reg=hp[HP.DeepL2Reg],
        )
        self.cross = CrossNet(
            input_dim=input_dim, num_layers=hp[HP.CrossLayerNum], l2_reg=hp[HP.CrossLayerL2Reg]
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        k_emb, k_dnn, k_cross = split_rng(generator, 3)
        params = {}
        params.update(self.embeddings.init(k_emb, device))
        if self.use_linear:
            params.update(self.linear.init(device))
        params.update(self.dnn.init(k_dnn, device))
        params.update(self.cross.init(k_cross, device))
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
        x0 = dnn_combine([feat_embeds] + self.dense_columns(batch))

        logit = self.dnn.apply(params, x0, training=training, generator=generator)
        logit = logit + self.cross.apply(params, x0, training=training)
        if linear_logit is not None:
            logit = logit + linear_logit
        return self.head.apply(params, logit)

    def l2(self, params):
        total = self.embeddings.l2(params) + self.dnn.l2(params) + self.cross.l2(params)
        if self.use_linear:
            total = total + self.linear.l2(params)
        return total
