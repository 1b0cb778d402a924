"""BST — Behavior Sequence Transformer (arXiv:1905.06874).

Counterpart of ``recman_tpu/models/bst.py``: each behavior sequence, with
the candidate item appended as the last position and learnable
positional embeddings ``{seq}_bst_pos`` added, runs through a stack of
masked transformer encoder blocks (``layers/bst.py``); the encoder
outputs, padded positions zeroed, are flattened and concatenated with
the plain field embeddings and dense columns into an MLP head. The
candidate's slot is never masked.
"""

from __future__ import annotations

import torch

from ..config import BSTHyperParams as HP
from ..device import resolve_device
from ..features import SequenceFeat
from ..layers import DNN, EmbeddingLayer, PredictionLayer, dnn_combine
from ..layers.bst import TransformerEncoderLayer
from ..utils import glorot_normal, l2_loss, split_rng
from .base import Model


class BST(Model):
    name = "bst"
    requires_sequence = True

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        k = hp[HP.EmbeddingSize]

        self.seq_feats = feat_dict.sequence_feats
        assert self.seq_feats, "BST requires at least one SequenceFeat"

        self.embeddings = EmbeddingLayer(feat_dict, k, hp[HP.EmbeddingL2Reg], use_bias=False)
        self.num_blocks = int(hp[HP.NumBlocks])
        self.encoders = {
            f.name: [
                TransformerEncoderLayer(
                    model_dim=k,
                    num_heads=hp[HP.NumHeads],
                    ff_hidden=hp[HP.FFHidden],
                    dropout_keep=hp[HP.AttDropOut],
                    activation=hp[HP.TransActivation],
                    l2_reg=hp[HP.TransL2Reg],
                    prefix=f"{f.name}_bst_{i}_",
                )
                for i in range(self.num_blocks)
            ]
            for f in self.seq_feats
        }
        n_plain_fields = sum(1 for f in self.embeddings.feats if not isinstance(f, SequenceFeat))
        seq_dims = sum((f.max_len + 1) * k for f in self.seq_feats)
        self.dnn = DNN(
            input_dim=n_plain_fields * k + seq_dims + len(feat_dict.dense_feats),
            hidden_units=hp[HP.DeepHiddenUnits],
            dropout_keep=hp[HP.DeepDropOut],
            activation=hp[HP.DeepActivation],
            l2_reg=hp[HP.DeepL2Reg],
        )
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        k = self.hparams[HP.EmbeddingSize]
        n_enc = len(self.seq_feats) * self.num_blocks
        ki = iter(split_rng(generator, 2 + len(self.seq_feats) + n_enc))
        params = {}
        params.update(self.embeddings.init(next(ki), device))
        params.update(self.dnn.init(next(ki), device))
        for f in self.seq_feats:
            # learnable positional embeddings over [history | candidate]
            params[f"{f.name}_bst_pos"] = glorot_normal(next(ki), (f.max_len + 1, k),
                                                        device=device)
            for enc in self.encoders[f.name]:
                params.update(enc.init(next(ki), device))
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        per_feat = self.embeddings.apply_dict(params, batch)
        towers = [per_feat[f.name] for f in self.embeddings.feats
                  if not isinstance(f, SequenceFeat)]  # (B, 1, k) each
        encoded = []
        for f in self.seq_feats:
            candidate = per_feat[f.id_feat.name]  # (B, 1, k)
            history = per_feat[f.name]  # (B, L, k), padding rows zeroed
            x = torch.cat([history, candidate], dim=1) + params[f"{f.name}_bst_pos"][None]
            ids = batch[f.name]
            mask = torch.cat([ids >= 0, torch.ones_like(ids[:, :1], dtype=torch.bool)], dim=1)
            for enc in self.encoders[f.name]:
                x = enc.apply(params, x, mask, training=training, generator=generator)
            # zero padded positions so the flatten is padding-invariant
            encoded.append(x * mask[:, :, None])
        dnn_input = dnn_combine(towers + encoded + self.dense_columns(batch))
        logit = self.dnn.apply(params, dnn_input, training=training, generator=generator)
        return self.head.apply(params, logit)

    def l2(self, params):
        total = self.embeddings.l2(params) + self.dnn.l2(params)
        for f in self.seq_feats:
            for enc in self.encoders[f.name]:
                total = total + enc.l2(params)
            if self.hparams[HP.TransL2Reg]:
                total = total + self.hparams[HP.TransL2Reg] * l2_loss(params[f"{f.name}_bst_pos"])
        return total
