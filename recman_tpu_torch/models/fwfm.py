"""FwFM, the Field-weighted Factorization Machine (arXiv:1806.03514).

Counterpart of ``recman_tpu/models/fwfm.py``: logit = linear +
first-order bias + sum_{i<j} r_ij <v_i, v_j>, one learned scalar per
field pair (``layers.FwFMLayer``). r starts at 1 on every pair, so step 0
is the FM model.
"""

from __future__ import annotations

from ..config import FwFMHyperParams as HP
from ..device import resolve_device
from ..layers import EmbeddingLayer, FwFMLayer, LinearLayer, PackedEmbeddingLinear, PredictionLayer
from .base import Model


class FwFM(Model):
    name = "fwfm"

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
        self.fwfm = FwFMLayer(
            num_fields=self.embeddings.field_size, l2_reg=hp[HP.FieldWeightL2Reg]
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        params = {}
        params.update(self.embeddings.init(generator, device))
        params.update(self.linear.init(device))
        params.update(self.fwfm.init(device=device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        feat_embeds, feat_bias, linear_logit = self.packed.apply(
            params, batch, training=training, override=linear_override
        )
        first_order = feat_bias.sum(dim=1)  # (B, 1)
        pair_logit = self.fwfm.apply(params, feat_embeds)
        return self.head.apply(params, linear_logit + first_order + pair_logit)

    def l2(self, params):
        return self.embeddings.l2(params) + self.linear.l2(params) + self.fwfm.l2(params)
