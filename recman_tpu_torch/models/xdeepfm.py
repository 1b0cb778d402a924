"""xDeepFM (arXiv:1803.05170).

Counterpart of ``recman_tpu/models/xdeepfm.py``: shared embeddings (no
bias) feeding linear + CIN + DNN towers; ``final_logit = linear + cin +
dnn`` -> sigmoid head. Loss = BCE + the sum of the tower L2s.
"""

from __future__ import annotations

import torch

from ..config import xDeepFMHyperParams as HP
from ..device import resolve_device
from ..utils import split_rng
from ..layers import (
    CIN,
    DNN,
    EmbeddingLayer,
    LinearLayer,
    PackedEmbeddingLinear,
    PredictionLayer,
    dnn_combine,
)
from .base import Model


class XDeepFM(Model):
    name = "xdeepfm"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp

        self.embeddings = EmbeddingLayer(
            feat_dict, hp[HP.EmbeddingSize], hp[HP.EmbeddingL2Reg], use_bias=False,
        )
        linear_feats = feat_dict.linear_features(hp[HP.LinearFeatures])
        self.linear = LinearLayer(linear_feats, hp[HP.LinearL2Reg])
        self.packed = PackedEmbeddingLinear(self.embeddings, self.linear)
        self.cin = CIN(
            field_size=self.embeddings.field_size,
            cross_layer_units=hp[HP.CinCrossLayerUnits],
            activation=hp[HP.CinActivation],
            dropout_keep=hp[HP.CinDropOut],
            l2_reg=hp[HP.CinL2Reg],
            compute_dtype=hp.get(HP.CinComputeDtype, "bfloat16"),
            remat=bool(hp.get(HP.CinRemat, False)),
        )
        dnn_input_dim = (
            self.embeddings.field_size * hp[HP.EmbeddingSize]
            + len(feat_dict.dense_feats)
        )
        self.dnn = DNN(
            input_dim=dnn_input_dim,
            hidden_units=hp[HP.DeepHiddenUnits],
            dropout_keep=hp[HP.DeepDropOut],
            activation=hp[HP.DeepActivation],
            l2_reg=hp[HP.DeepL2Reg],
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator: torch.Generator, device=None) -> dict:
        """Random params drawn from ``generator`` (on its own device; a
        ``utils.JaxKey`` draws the reference's), placed on ``device``
        (default CUDA; raises without a GPU)."""
        device = resolve_device(device)
        k_emb, k_cin, k_dnn = split_rng(generator, 3)
        params = {}
        params.update(self.embeddings.init(k_emb, device))
        params.update(self.linear.init(device))
        params.update(self.cin.init(k_cin, device))
        params.update(self.dnn.init(k_dnn, device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        feat_embeds, _, linear_logit = self.packed.apply(
            params, batch, training=training, override=linear_override
        )
        cin_logit = self.cin.apply(params, feat_embeds, training=training, generator=generator)
        dnn_input = dnn_combine([feat_embeds] + self.dense_columns(batch))
        dnn_logit = self.dnn.apply(params, dnn_input, training=training, generator=generator)
        return self.head.apply(params, linear_logit + cin_logit + dnn_logit)

    def l2(self, params):
        """Sum of the tower L2s (reference xdeepfm.py:92-99)."""
        return (
            self.embeddings.l2(params)
            + self.linear.l2(params)
            + self.dnn.l2(params)
            + self.cin.l2(params)
        )
