"""Embedding layer: per-feature tables, typed lookup dispatch, sqrtn combine.

Counterpart of ``recman_tpu/layers/embedding.py``. Lookup by feature type:

- SparseFeat        -> table[id]                                  (B, 1, k)
- SparseValueFeat   -> table[id] * value                          (B, 1, k)
- MultiVal*Feat     -> sqrtn-combine over present ids             (B, 1, k)
- SequenceFeat      -> lookup into the tied id-feature table,
                       padding rows zeroed                        (B, L, k)

Embeddings mask padding (PAD_ID = -1, so ids >= 0 take part) and keep the
OOV id 0. QR compositional tables (``qr_collisions``) are not ported yet.
"""

from __future__ import annotations

import torch

from ..features import (
    MultiValCsvFeat,
    MultiValSparseFeat,
    SequenceFeat,
    SparseFeat,
    SparseValueFeat,
)
from ..ops.embedding import _stacked_ctx, embedding_lookup
from ..utils import glorot_normal, l2_loss


def sqrtn_combine(table, ids):
    """Rows of ``table`` for padded id lists ``ids`` (B, L) -> (B, k):
    sum of present rows / sqrt(#present); zeros where none is present."""
    mask = (ids >= 0).to(table.dtype)
    rows = embedding_lookup(table, ids.clamp_min(0))  # (B, L, k)
    summed = torch.einsum("blk,bl->bk", rows, mask)
    count = mask.sum(dim=1, keepdim=True)
    return summed * torch.where(
        count > 0, 1.0 / torch.sqrt(count.clamp_min(1.0)), 0.0
    )


def check_qr_unsupported(feats):
    for f in feats:
        if getattr(f, "qr_collisions", None) is not None:
            raise NotImplementedError(
                f"QR embeddings (qr_collisions on {f.name!r}) not ported yet"
            )


class EmbeddingLayer:
    """All embedding tables of a FeatureSet. Param names match the
    reference: ``{prefix}{feat}_feat_embed`` (feat_size, k) and, with
    ``use_bias``, ``{prefix}{feat}_feat_bias`` (feat_size,)."""

    def __init__(self, feature_set, embedding_size, l2_reg=1e-5, use_bias=True, prefix=""):
        self.feats = feature_set.embedding_feats
        check_qr_unsupported(self.feats)
        self.embedding_size = embedding_size
        self.l2_reg = l2_reg
        self.use_bias = use_bias
        self.prefix = prefix

    @property
    def field_size(self) -> int:
        """Field slots on the concat axis (a sequence feat takes max_len)."""
        return sum(
            f.max_len if isinstance(f, SequenceFeat) else 1 for f in self.feats
        )

    def _owns_table(self, feat) -> bool:
        return not isinstance(feat, SequenceFeat)  # sequence feats tie to id_feat

    def init(self, generator, device=None) -> dict:
        params = {}
        for feat in self.feats:
            if not self._owns_table(feat):
                continue
            params[f"{self.prefix}{feat.name}_feat_embed"] = glorot_normal(
                generator, (feat.feat_size, self.embedding_size), device=device
            )
            if self.use_bias:
                params[f"{self.prefix}{feat.name}_feat_bias"] = torch.zeros(
                    (feat.feat_size,), dtype=torch.float32, device=device
                )
        return params

    def _tables(self, params, feat):
        owner = feat.id_feat.name if isinstance(feat, SequenceFeat) else feat.name
        table = params[f"{self.prefix}{owner}_feat_embed"]
        bias = params.get(f"{self.prefix}{owner}_feat_bias") if self.use_bias else None
        if bias is not None:
            bias = bias[:, None]  # stored 1-D; lookups want (V, 1)
        return table, bias

    def _lookup(self, params, feat, batch):
        """Per-feature lookup -> (embeds (B, n_slots, k), bias (B, n_slots, 1) | None)."""
        table, bias_table = self._tables(params, feat)

        def one(t):
            if isinstance(feat, SparseFeat):
                return embedding_lookup(t, batch[feat.name])[:, None, :]
            if isinstance(feat, SparseValueFeat):
                rows = embedding_lookup(t, batch[feat.name])
                return (rows * batch[feat.value_key][:, None])[:, None, :]
            if isinstance(feat, (MultiValCsvFeat, MultiValSparseFeat)):
                return sqrtn_combine(t, batch[feat.name])[:, None, :]
            if isinstance(feat, SequenceFeat):
                ids = batch[feat.name]
                mask = (ids >= 0).to(t.dtype)[:, :, None]
                return embedding_lookup(t, ids.clamp_min(0)) * mask
            raise NotImplementedError(type(feat))

        embeds = one(table)
        bias = one(bias_table) if bias_table is not None else None
        return embeds, bias

    def l2(self, params):
        """Summed per-table L2 (reference layers.py:188-193, 263-267).

        Under stacked table storage (``ops.embedding.stacked_tables``) the
        stack's L2 replaces the per-table terms only when the context's
        names are exactly this layer's owned feats in the context, in
        order — the reference's gate (recman_tpu/layers/embedding.py:
        221-267), kept as it is."""
        sc = _stacked_ctx()
        stacked_names = ()
        if sc is not None:
            in_ctx = set(sc[0])
            own = tuple(
                f.name for f in self.feats if self._owns_table(f) and f.name in in_ctx
            )
            if own == sc[0]:
                stacked_names = in_ctx
        total = 0.0
        stacked_hit = False
        for feat in self.feats:
            if not self._owns_table(feat):
                continue
            if feat.name in stacked_names:
                stacked_hit = True
                continue
            total = total + self.l2_reg * l2_loss(
                params[f"{self.prefix}{feat.name}_feat_embed"]
            )
        if stacked_hit:
            total = total + self.l2_reg * l2_loss(sc[1])
        return total
