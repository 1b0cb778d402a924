"""FM, the factorization machine (Rendle 2010).

Counterpart of ``recman_tpu/models/fm.py``: logit = linear + FMLayer over
the shared embeddings, whose bias tables give the first-order term.
"""

from __future__ import annotations

from ..config import FMHyperParams as HP
from ..device import resolve_device
from ..layers import EmbeddingLayer, FMLayer, LinearLayer, PackedEmbeddingLinear, PredictionLayer
from .base import Model


class FM(Model):
    name = "fm"

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
        self.fm = FMLayer(dropout_keep=hp[HP.FMDropOut])
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        params = {}
        params.update(self.embeddings.init(generator, device))
        params.update(self.linear.init(device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        feat_embeds, feat_bias, linear_logit = self.packed.apply(
            params, batch, training=training, override=linear_override
        )
        fm_logit = self.fm.apply(params, feat_embeds, feat_bias, training=training,
                                 generator=generator)
        return self.head.apply(params, linear_logit + fm_logit)

    def l2(self, params):
        return self.embeddings.l2(params) + self.linear.l2(params)
