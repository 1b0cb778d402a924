"""FinalMLP (arXiv:2304.00902).

Counterpart of ``recman_tpu/models/final_mlp.py``: two MLP streams over
the shared field embeddings, each behind its own feature-selection gate,
fused by a multi-head bilinear aggregation (``layers/final_mlp.py``).
A stream's gate is context-free (a learnable vector, the default) or,
with feature names in ``fs1_context`` / ``fs2_context``, context-aware on
those fields' embeddings (a ``SequenceFeat`` gives its ``max_len``
slots). The dense columns are appended after the gate, so that the gate
covers the embedding slots only.
"""

from __future__ import annotations

from ..config import FinalMLPHyperParams as HP
from ..device import resolve_device
from ..features import SequenceFeat
from ..layers import (
    EmbeddingLayer,
    FeatureSelectionGate,
    InteractionAggregation,
    MLPBlock,
    PredictionLayer,
    dnn_combine,
)
from ..layers.common import DeviceIndex
from ..utils import split_rng
from .base import Model


class FinalMLP(Model):
    name = "final_mlp"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        k = hp[HP.EmbeddingSize]

        self.embeddings = EmbeddingLayer(feat_dict, k, hp[HP.EmbeddingL2Reg], use_bias=False)
        flat_dim = self.embeddings.field_size * k
        n_dense = len(feat_dict.dense_feats)

        self._ctx_slots1 = self._context_slots(hp[HP.FS1Context])
        self._ctx_slots2 = self._context_slots(hp[HP.FS2Context])
        self._slot_index = {s: DeviceIndex(s) for s in (self._ctx_slots1, self._ctx_slots2) if s}

        def gate(slots, prefix):
            return FeatureSelectionGate(
                target_dim=flat_dim,
                context_dim=len(slots) * k if slots else k,
                hidden_dim=int(hp[HP.FSGateHidden]),
                context_free=not slots,
                l2_reg=hp[HP.FSL2Reg],
                prefix=prefix,
            )

        def mlp(units, keeps, prefix):
            return MLPBlock(input_dim=flat_dim + n_dense, hidden_units=hp[units],
                            dropout_keep=hp[keeps], activation=hp[HP.MlpActivation],
                            l2_reg=hp[HP.MlpL2Reg], prefix=prefix)

        self.fs1 = gate(self._ctx_slots1, "final_fs1_")
        self.fs2 = gate(self._ctx_slots2, "final_fs2_")
        self.mlp1 = mlp(HP.Mlp1HiddenUnits, HP.Mlp1DropOut, "final_mlp1_")
        self.mlp2 = mlp(HP.Mlp2HiddenUnits, HP.Mlp2DropOut, "final_mlp2_")
        self.agg = InteractionAggregation(
            dim1=self.mlp1.output_dim, dim2=self.mlp2.output_dim, num_heads=hp[HP.NumHeads],
            l2_reg=hp[HP.MlpL2Reg], prefix="final_agg_",
        )
        self.head = PredictionLayer(task)

    def _context_slots(self, names) -> tuple:
        """The nominated features' slots on the field axis."""
        if not names:
            return ()
        names = set(names)
        slots, pos = [], 0
        for feat in self.embeddings.feats:
            width = feat.max_len if isinstance(feat, SequenceFeat) else 1
            if feat.name in names:
                slots.extend(range(pos, pos + width))
                names.discard(feat.name)
            pos += width
        assert not names, f"unknown fs context features: {sorted(names)}"
        return tuple(slots)

    def init_params(self, generator, device=None) -> dict:
        device = resolve_device(device)
        k_emb, k_f1, k_f2, k_m1, k_m2, k_agg = split_rng(generator, 6)
        params = {}
        params.update(self.embeddings.init(k_emb, device))
        params.update(self.fs1.init(k_f1, device))
        params.update(self.fs2.init(k_f2, device))
        params.update(self.mlp1.init(k_m1, device))
        params.update(self.mlp2.init(k_m2, device))
        params.update(self.agg.init(k_agg, device))
        params.update(self.head.init(device))
        return params

    def _gate_context(self, feat_embeds, slots):
        if not slots:
            return None
        (index,) = self._slot_index[slots].on(feat_embeds.device)
        return feat_embeds[:, index, :].reshape(feat_embeds.shape[0], -1)

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        feat_embeds, _ = self.embeddings.apply(params, batch)  # (B, F, k)
        flat = feat_embeds.reshape(feat_embeds.shape[0], -1)
        dense = self.dense_columns(batch)
        g1 = self.fs1.apply(params, flat, self._gate_context(feat_embeds, self._ctx_slots1))
        g2 = self.fs2.apply(params, flat, self._gate_context(feat_embeds, self._ctx_slots2))
        o1 = self.mlp1.apply(params, dnn_combine([g1] + dense), training=training,
                             generator=generator)
        o2 = self.mlp2.apply(params, dnn_combine([g2] + dense), training=training,
                             generator=generator)
        return self.head.apply(params, self.agg.apply(params, o1, o2))

    def l2(self, params):
        return (self.embeddings.l2(params) + self.fs1.l2(params) + self.fs2.l2(params)
                + self.mlp1.l2(params) + self.mlp2.l2(params) + self.agg.l2(params))
