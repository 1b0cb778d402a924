"""PNN, the Product-based Neural Network (arXiv:1611.00144).

Counterpart of ``recman_tpu/models/pnn.py``: the field embeddings, the
product signal (``layers/product.py``: inner, outer or both), the flat
embeddings and the dense columns, concatenated into a DNN. No linear
tower, as in the paper.
"""

from __future__ import annotations

from ..config import PNNHyperParams as HP
from ..device import resolve_device
from ..layers import DNN, EmbeddingLayer, PredictionLayer, ProductLayer, dnn_combine
from ..utils import split_rng
from .base import Model


class PNN(Model):
    name = "pnn"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        k = hp[HP.EmbeddingSize]

        self.embeddings = EmbeddingLayer(feat_dict, k, hp[HP.EmbeddingL2Reg], use_bias=False)
        self.product = ProductLayer(
            num_fields=self.embeddings.field_size, embedding_size=k, kind=hp[HP.ProductType]
        )
        self.dnn = DNN(
            # z (the flat embeddings), p (the product signal), the dense columns
            input_dim=self.embeddings.field_size * k + self.product.output_dim
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
        params.update(self.dnn.init(k_dnn, device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        feat_embeds, _ = self.embeddings.apply(params, batch)
        p = self.product.apply(params, feat_embeds)
        dnn_input = dnn_combine([feat_embeds, p] + self.dense_columns(batch))
        logit = self.dnn.apply(params, dnn_input, training=training, generator=generator)
        return self.head.apply(params, logit)

    def l2(self, params):
        return self.embeddings.l2(params) + self.dnn.l2(params)
