"""DeepFM (arXiv:1703.04247).

Counterpart of ``recman_tpu/models/deepfm.py``: linear + FM + DNN towers
over shared embeddings, with the ``use_fm`` / ``use_deep`` toggles.
"""

from __future__ import annotations

from ..config import DeepFMHyperParams as HP
from ..device import resolve_device
from ..utils import split_rng
from ..layers import (
    DNN,
    EmbeddingLayer,
    FMLayer,
    LinearLayer,
    PackedEmbeddingLinear,
    PredictionLayer,
    dnn_combine,
)
from .base import Model


class DeepFM(Model):
    name = "deepfm"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        self.use_fm = bool(hp[HP.UseFM])
        self.use_deep = bool(hp[HP.UseDeep])
        assert self.use_fm or self.use_deep

        self.embeddings = EmbeddingLayer(
            feat_dict, hp[HP.EmbeddingSize], hp[HP.EmbeddingL2Reg], use_bias=True
        )
        self.linear = LinearLayer(
            feat_dict.linear_features(hp[HP.LinearFeatures]), hp[HP.LinearL2Reg]
        )
        self.packed = PackedEmbeddingLinear(self.embeddings, self.linear)
        self.fm = FMLayer(dropout_keep=hp[HP.FMDropOut])
        if self.use_deep:
            self.dnn = DNN(
                input_dim=self.embeddings.field_size * hp[HP.EmbeddingSize]
                + len(feat_dict.dense_feats),
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
        if self.use_deep:
            params.update(self.dnn.init(k_dnn, device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        feat_embeds, feat_bias, logit = self.packed.apply(
            params, batch, training=training, override=linear_override
        )
        if self.use_fm:
            logit = logit + self.fm.apply(params, feat_embeds, feat_bias, training=training,
                                          generator=generator)
        if self.use_deep:
            dnn_input = dnn_combine([feat_embeds] + self.dense_columns(batch))
            logit = logit + self.dnn.apply(params, dnn_input, training=training,
                                           generator=generator)
        return self.head.apply(params, logit)

    def l2(self, params):
        total = self.embeddings.l2(params) + self.linear.l2(params)
        if self.use_deep:
            total = total + self.dnn.l2(params)
        return total
