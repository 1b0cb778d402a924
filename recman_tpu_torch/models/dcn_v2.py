"""DCN-V2 (arXiv:2008.13535) and GDCN (arXiv:2311.04635).

Counterpart of ``recman_tpu/models/dcn_v2.py``: full- or low-rank cross
layers (``layers/cross_v2.py``; a mixture of low-rank experts, or GDCN's
information gate) and a DNN over the same combined input x0 (embeddings,
then the dense columns), in the paper's two structures:

- ``structure="stacked"``: x0 -> cross tower (no head) -> DNN -> logit;
  the cross head's ``cross_v2_w`` and ``cross_v2_w0`` stay in the params
  unused (zero gradient) and outside the L2;
- ``structure="parallel"``: the cross tower's and the DNN's logits sum.

The optional linear tower comes from the packed lookup; without it the
embeddings come from ``EmbeddingLayer.apply``.
"""

from __future__ import annotations

from ..config import DCNv2HyperParams as HP
from ..device import resolve_device
from ..layers import (
    DNN,
    CrossNetV2,
    EmbeddingLayer,
    LinearLayer,
    PackedEmbeddingLinear,
    PredictionLayer,
    dnn_combine,
)
from ..utils import l2_loss, split_rng
from .base import Model


class DCNv2(Model):
    name = "dcn_v2"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        self.use_linear = bool(hp[HP.UseLinear])
        self.structure = hp[HP.Structure]
        assert self.structure in ("stacked", "parallel")

        self.embeddings = EmbeddingLayer(
            feat_dict, hp[HP.EmbeddingSize], hp[HP.EmbeddingL2Reg], use_bias=False
        )
        if self.use_linear:
            self.linear = LinearLayer(
                feat_dict.linear_features(hp[HP.LinearFeatures]), hp[HP.LinearL2Reg]
            )
            self.packed = PackedEmbeddingLinear(self.embeddings, self.linear)
        self.input_dim = (
            self.embeddings.field_size * hp[HP.EmbeddingSize] + len(feat_dict.dense_feats)
        )
        self.cross = CrossNetV2(
            input_dim=self.input_dim,
            num_layers=hp[HP.CrossLayerNum],
            rank=hp[HP.CrossRank],
            num_experts=hp[HP.CrossNumExperts],
            l2_reg=hp[HP.CrossLayerL2Reg],
            gated=bool(hp[HP.CrossGated]),
        )
        self.dnn = DNN(
            input_dim=self.input_dim,
            hidden_units=hp[HP.DeepHiddenUnits],
            dropout_keep=hp[HP.DeepDropOut],
            activation=hp[HP.DeepActivation],
            l2_reg=hp[HP.DeepL2Reg],
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        k_emb, k_dnn, k_cross = split_rng(generator, 3)
        params = {}
        params.update(self.embeddings.init(k_emb, device))
        if self.use_linear:
            params.update(self.linear.init(device))
        params.update(self.cross.init(k_cross, device))
        params.update(self.dnn.init(k_dnn, device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        if self.use_linear:
            feat_embeds, _, logit = self.packed.apply(
                params, batch, training=training, override=linear_override
            )
        else:
            feat_embeds, _ = self.embeddings.apply(params, batch)
            logit = None
        x0 = dnn_combine([feat_embeds] + self.dense_columns(batch))

        if self.structure == "stacked":
            towers = [self.dnn.apply(params, self.cross.features(params, x0), training=training,
                                     generator=generator)]
        else:
            towers = [self.cross.apply(params, x0, training=training),
                      self.dnn.apply(params, x0, training=training, generator=generator)]
        for t in towers:  # summed as the reference sums them: linear, cross, deep
            logit = t if logit is None else logit + t
        return self.head.apply(params, logit)

    def l2(self, params):
        total = self.embeddings.l2(params) + self.dnn.l2(params)
        if self.use_linear:
            total = total + self.linear.l2(params)
        if self.structure == "parallel":
            return total + self.cross.l2(params)
        # stacked: the head is unused; the layers' matrices only
        for name in self.cross.layer_weight_names():
            total = total + self.cross.l2_reg * l2_loss(params[name])
        return total


class GDCN(DCNv2):
    """GDCN, the Gated Deep Cross Network: DCN-V2 with an information gate
    on every full-rank cross layer. GDCN-S and GDCN-P are
    ``structure="stacked"`` and ``"parallel"``."""

    name = "gdcn"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        hp = {"cross_gated": True}
        hp.update(hparams or {})
        assert hp["cross_gated"], "GDCN is the gated variant by definition"
        super().__init__(feat_dict, hp, task=task)
