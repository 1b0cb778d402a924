"""DIN — Deep Interest Network (arXiv:1706.06978).

Counterpart of ``recman_tpu/models/din.py``:

- every SequenceFeat's behavior sequence is pooled by attention against
  its tied id-feature's candidate embedding (``layers.ASPLayer``)
- deep input = [non-sequence field embeddings, pooled sequence vectors,
  dense columns] -> DNN (Dice by default) -> sigmoid

Each feature is looked up on its own (``EmbeddingLayer.apply_dict``), so
under ``grad_kernel("segmat")`` every lookup's backward is one K6 launch,
the candidate's and the history's into the item table among them.
"""

from __future__ import annotations

from ..config import DINHyperParams as HP
from ..device import resolve_device
from ..features import SequenceFeat
from ..layers import ASPLayer, DNN, EmbeddingLayer, PredictionLayer, dnn_combine
from ..utils import split_rng
from .base import Model


class DIN(Model):
    name = "din"
    requires_sequence = True
    supports_moment_capture = True

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp

        self.seq_feats = feat_dict.sequence_feats
        assert self.seq_feats, "DIN requires at least one SequenceFeat"

        self.embeddings = EmbeddingLayer(
            feat_dict, hp[HP.EmbeddingSize], hp[HP.EmbeddingL2Reg], use_bias=False
        )
        self.asp = {
            f.name: ASPLayer(
                embedding_size=hp[HP.EmbeddingSize],
                att_hidden_units=hp[HP.AttHiddenUnits],
                activation=hp[HP.AttActivation],
                weight_normalization=hp[HP.AttWeightNormalization],
                prefix=f"{f.name}_",
            )
            for f in self.seq_feats
        }
        n_plain_fields = sum(1 for f in self.embeddings.feats if not isinstance(f, SequenceFeat))
        self.dnn = DNN(
            input_dim=(n_plain_fields + len(self.seq_feats)) * hp[HP.EmbeddingSize]
            + len(feat_dict.dense_feats),
            hidden_units=hp[HP.DeepHiddenUnits],
            dropout_keep=hp[HP.DeepDropOut],
            activation=hp[HP.DeepActivation],
            l2_reg=hp[HP.DeepL2Reg],
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        keys = split_rng(generator, 2 + len(self.seq_feats))
        params = {}
        params.update(self.embeddings.init(keys[0], device))
        params.update(self.dnn.init(keys[1], device))
        for sub, f in zip(keys[2:], self.seq_feats):
            params.update(self.asp[f.name].init(sub, device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None,
              moment_capture=None):
        per_feat = self.embeddings.apply_dict(params, batch)
        towers = [per_feat[f.name] for f in self.embeddings.feats
                  if not isinstance(f, SequenceFeat)]  # (B, 1, k) each
        pooled = [
            self.asp[f.name].apply(
                params, per_feat[f.id_feat.name][:, 0, :], per_feat[f.name], batch[f.name] >= 0,
                training=training, moment_capture=moment_capture,
            )
            for f in self.seq_feats
        ]
        dnn_input = dnn_combine(towers + pooled + self.dense_columns(batch))
        logit = self.dnn.apply(params, dnn_input, training=training, generator=generator,
                               moment_capture=moment_capture)
        return self.head.apply(params, logit)

    def l2(self, params):
        total = self.embeddings.l2(params) + self.dnn.l2(params)
        for f in self.seq_feats:
            total = total + self.asp[f.name].l2(params)
        return total
