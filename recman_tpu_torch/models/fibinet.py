"""FiBiNET (arXiv:1905.09433).

Counterpart of ``recman_tpu/models/fibinet.py``: SENET reweighting and
bilinear interactions (``layers/senet.py``). The DNN reads the bilinear
interactions of the embeddings and, through a second bilinear layer with
its own weights, those of the SENET-reweighted embeddings (the paper's
eq. 12), then the dense columns; the logit is linear + DNN, the linear
tower from the packed lookup.
"""

from __future__ import annotations

from ..config import FiBiNETHyperParams as HP
from ..device import resolve_device
from ..layers import (
    DNN,
    BilinearInteraction,
    EmbeddingLayer,
    LinearLayer,
    PackedEmbeddingLinear,
    PredictionLayer,
    SENETLayer,
    dnn_combine,
)
from ..utils import split_rng
from .base import Model


class FiBiNET(Model):
    name = "fibinet"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        k = hp[HP.EmbeddingSize]

        self.embeddings = EmbeddingLayer(feat_dict, k, hp[HP.EmbeddingL2Reg], use_bias=False)
        self.linear = LinearLayer(
            feat_dict.linear_features(hp[HP.LinearFeatures]), hp[HP.LinearL2Reg]
        )
        self.packed = PackedEmbeddingLinear(self.embeddings, self.linear)
        f = self.embeddings.field_size
        self.senet = SENETLayer(num_fields=f, reduction_ratio=hp[HP.ReductionRatio],
                                l2_reg=hp[HP.SENETL2Reg])
        self.bilinear = BilinearInteraction(f, k, bilinear_type=hp[HP.BilinearType],
                                            l2_reg=hp[HP.BilinearL2Reg], prefix="bilinear_")
        self.bilinear_se = BilinearInteraction(f, k, bilinear_type=hp[HP.BilinearType],
                                               l2_reg=hp[HP.BilinearL2Reg], prefix="bilinear_se_")
        self.dnn = DNN(
            input_dim=2 * self.bilinear.output_dim + len(feat_dict.dense_feats),
            hidden_units=hp[HP.DeepHiddenUnits],
            dropout_keep=hp[HP.DeepDropOut],
            activation=hp[HP.DeepActivation],
            l2_reg=hp[HP.DeepL2Reg],
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        k_emb, k_se, k_bi, k_bise, k_dnn = split_rng(generator, 5)
        params = {}
        params.update(self.embeddings.init(k_emb, device))
        params.update(self.linear.init(device))
        params.update(self.senet.init(k_se, device))
        params.update(self.bilinear.init(k_bi, device))
        params.update(self.bilinear_se.init(k_bise, device))
        params.update(self.dnn.init(k_dnn, device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        feat_embeds, _, linear_logit = self.packed.apply(
            params, batch, training=training, override=linear_override
        )
        p = self.bilinear.apply(params, feat_embeds)  # (B, P, k)
        q = self.bilinear_se.apply(params, self.senet.apply(params, feat_embeds))
        dnn_input = dnn_combine([p, q] + self.dense_columns(batch))
        deep_logit = self.dnn.apply(params, dnn_input, training=training, generator=generator)
        return self.head.apply(params, linear_logit + deep_logit)

    def l2(self, params):
        return (self.embeddings.l2(params) + self.linear.l2(params) + self.senet.l2(params)
                + self.bilinear.l2(params) + self.bilinear_se.l2(params) + self.dnn.l2(params))
