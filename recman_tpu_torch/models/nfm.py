"""NFM, the Neural Factorization Machine (arXiv:1708.05027).

Counterpart of ``recman_tpu/models/nfm.py``: logit = linear +
first-order bias + DNN(Bi-Interaction pooling, dense columns).
"""

from __future__ import annotations

from ..config import NFMHyperParams as HP
from ..device import resolve_device
from ..utils import split_rng
from ..layers import (
    DNN,
    BiInteractionPooling,
    EmbeddingLayer,
    LinearLayer,
    PackedEmbeddingLinear,
    PredictionLayer,
    dnn_combine,
)
from .base import Model


class NFM(Model):
    name = "nfm"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp

        self.embeddings = EmbeddingLayer(
            feat_dict, hp[HP.EmbeddingSize], hp[HP.EmbeddingL2Reg], use_bias=True
        )
        self.linear = LinearLayer(
            feat_dict.linear_features(hp[HP.LinearFeatures]), hp[HP.LinearL2Reg]
        )
        self.packed = PackedEmbeddingLinear(self.embeddings, self.linear)
        self.bi = BiInteractionPooling(dropout_keep=hp[HP.BiDropOut])
        self.dnn = DNN(
            input_dim=hp[HP.EmbeddingSize] + len(feat_dict.dense_feats),
            hidden_units=hp[HP.DeepHiddenUnits],
            dropout_keep=hp[HP.DeepDropOut],
            activation=hp[HP.DeepActivation],
            l2_reg=hp[HP.DeepL2Reg],
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        k_emb, k_dnn = split_rng(generator, 2)
        params = {}
        params.update(self.embeddings.init(k_emb, device))
        params.update(self.linear.init(device))
        params.update(self.dnn.init(k_dnn, device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        feat_embeds, feat_bias, linear_logit = self.packed.apply(
            params, batch, training=training, override=linear_override
        )
        first_order = feat_bias.sum(dim=1)  # (B, 1), NFM eq. 2's sum of w_i x_i
        pooled = self.bi.apply(params, feat_embeds, training=training, generator=generator)
        dnn_input = dnn_combine([pooled] + self.dense_columns(batch))
        deep_logit = self.dnn.apply(params, dnn_input, training=training, generator=generator)
        return self.head.apply(params, linear_logit + first_order + deep_logit)

    def l2(self, params):
        return self.embeddings.l2(params) + self.linear.l2(params) + self.dnn.l2(params)
