"""DIEN — Deep Interest Evolution Network (arXiv:1809.03672).

Counterpart of ``recman_tpu/models/dien.py``:

- each SequenceFeat's behaviors run through a GRU interest extractor and
  an attentional-update-gate AUGRU evolution stage against the candidate
  item (``layers/dien.py``)
- deep input = [non-sequence field embeddings, final interest states,
  dense columns] -> DNN (Dice by default) -> sigmoid
- an opt-in auxiliary next-behavior loss on the extracted states
  (``aux_loss_weight`` > 0), with in-batch negatives, in training only
"""

from __future__ import annotations

from ..config import DIENHyperParams as HP
from ..device import resolve_device
from ..features import SequenceFeat
from ..layers import DNN, EmbeddingLayer, PredictionLayer, dnn_combine
from ..layers.dien import InterestEvolution
from ..utils import split_rng
from .base import Model


class DIEN(Model):
    name = "dien"
    requires_sequence = True
    supports_moment_capture = True

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        k = hp[HP.EmbeddingSize]

        self.seq_feats = feat_dict.sequence_feats
        assert self.seq_feats, "DIEN requires at least one SequenceFeat"

        self.embeddings = EmbeddingLayer(feat_dict, k, hp[HP.EmbeddingL2Reg], use_bias=False)
        hidden = hp[HP.GruHidden] or k
        self.evolution = {
            f.name: InterestEvolution(embedding_size=k, hidden_size=hidden,
                                      l2_reg=hp[HP.GruL2Reg], prefix=f"{f.name}_")
            for f in self.seq_feats
        }
        self.aux_weight = float(hp[HP.AuxLossWeight])
        n_plain_fields = sum(1 for f in self.embeddings.feats if not isinstance(f, SequenceFeat))
        self.dnn = DNN(
            input_dim=n_plain_fields * k + len(self.seq_feats) * hidden
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
            params.update(self.evolution[f.name].init(sub, device))
        params.update(self.head.init(device))
        return params

    def _forward(self, params, batch, training, generator, moment_capture=None):
        """Returns (predictions, weighted auxiliary loss)."""
        per_feat = self.embeddings.apply_dict(params, batch)
        towers = [per_feat[f.name] for f in self.embeddings.feats
                  if not isinstance(f, SequenceFeat)]
        interests, aux = [], 0.0
        for f in self.seq_feats:
            query = per_feat[f.id_feat.name][:, 0, :]  # (B, k) candidate
            seq = per_feat[f.name]  # (B, L, k), padding rows zeroed
            mask = batch[f.name] >= 0
            final, states = self.evolution[f.name].apply(params, seq, mask, query)
            interests.append(final)
            if self.aux_weight > 0.0 and training:
                aux = aux + self.evolution[f.name].aux_loss(params, states, seq, mask)
        dnn_input = dnn_combine(towers + interests + self.dense_columns(batch))
        logit = self.dnn.apply(params, dnn_input, training=training, generator=generator,
                               moment_capture=moment_capture)
        return self.head.apply(params, logit), self.aux_weight * aux

    def apply(self, params, batch, training=False, generator=None, linear_override=None,
              moment_capture=None):
        return self._forward(params, batch, training, generator, moment_capture)[0]

    def loss(self, params, batch, training=True, generator=None, weights=None):
        """BCE + L2 + the weighted auxiliary loss (paper eq. 8:
        L = L_target + alpha * L_aux)."""
        preds, aux = self._forward(params, batch, training, generator)
        return self.data_loss(batch["y"], preds, weights) + self.l2(params) + aux

    def l2(self, params):
        total = self.embeddings.l2(params) + self.dnn.l2(params)
        for f in self.seq_feats:
            total = total + self.evolution[f.name].l2(params)
        return total
