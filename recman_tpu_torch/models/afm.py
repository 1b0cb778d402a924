"""AFM, the Attentional Factorization Machine (arXiv:1708.04617).

Counterpart of ``recman_tpu/models/afm.py``: linear + the AFM attention
tower over shared embeddings (no embedding bias).
"""

from __future__ import annotations

from ..config import AFMHyperParams as HP
from ..device import resolve_device
from ..utils import split_rng
from ..layers import AFMLayer, EmbeddingLayer, LinearLayer, PackedEmbeddingLinear, PredictionLayer
from .base import Model


class AFM(Model):
    name = "afm"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp

        self.embeddings = EmbeddingLayer(
            feat_dict, hp[HP.EmbeddingSize], hp[HP.EmbeddingL2Reg], use_bias=False
        )
        self.linear = LinearLayer(
            feat_dict.linear_features(hp[HP.LinearFeatures]), hp[HP.LinearL2Reg]
        )
        self.packed = PackedEmbeddingLinear(self.embeddings, self.linear)
        self.afm = AFMLayer(
            field_size=self.embeddings.field_size,
            embedding_size=hp[HP.EmbeddingSize],
            att_factor=hp[HP.AttFactor],
            att_dropout=hp[HP.AttDropOut],
            l2_reg=hp[HP.AttL2Reg],
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        k_emb, k_afm = split_rng(generator, 2)
        params = {}
        params.update(self.embeddings.init(k_emb, device))
        params.update(self.linear.init(device))
        params.update(self.afm.init(k_afm, device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        feat_embeds, _, linear_logit = self.packed.apply(
            params, batch, training=training, override=linear_override
        )
        afm_logit = self.afm.apply(params, feat_embeds, training=training, generator=generator)
        return self.head.apply(params, linear_logit + afm_logit)

    def l2(self, params):
        return self.embeddings.l2(params) + self.linear.l2(params) + self.afm.l2(params)
