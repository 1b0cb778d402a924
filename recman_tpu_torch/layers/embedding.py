"""Embedding layer: per-feature tables, typed lookup dispatch, sqrtn combine.

Counterpart of ``recman_tpu/layers/embedding.py``. Lookup by feature type:

- SparseFeat        -> table[id]                                  (B, 1, k)
- SparseValueFeat   -> table[id] * value                          (B, 1, k)
- MultiVal*Feat     -> sqrtn-combine over present ids             (B, 1, k)
- SequenceFeat      -> lookup into the tied id-feature table,
                       padding rows zeroed                        (B, L, k)

Embeddings mask padding (PAD_ID = -1, so ids >= 0 take part) and keep the
OOV id 0. ``apply`` concatenates every feature's lookup along the field
axis, the plain sparse feats through one ``embedding_lookup_grouped``
call (and their bias tables through another).

A single-id sparse feature with ``qr_collisions`` q (QR compositional
embeddings, reference :78-151) owns two tables in place of its (V, k)
one: ``{prefix}{feat}_feat_embed_q`` (ceil(V/q), k) and ``_feat_embed_r``
(q, k), and its rows are Q[id // q] + R[id % q]; its bias stays
full-size. Each of the two lookups is an ``embedding_lookup`` of its own,
so under ``grad_kernel("segmat")`` on CUDA each runs K6 in the backward.
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
from ..ops.embedding import _stacked_ctx, embedding_lookup, embedding_lookup_grouped
from ..utils import glorot_normal, l2_loss, split_rng


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


class EmbeddingLayer:
    """All embedding tables of a FeatureSet. Param names match the
    reference: ``{prefix}{feat}_feat_embed`` (feat_size, k) and, with
    ``use_bias``, ``{prefix}{feat}_feat_bias`` (feat_size,)."""

    def __init__(self, feature_set, embedding_size, l2_reg=1e-5, use_bias=True, prefix=""):
        self.feats = feature_set.embedding_feats
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

    def _is_qr(self, feat) -> bool:
        """A QR feature: quotient and remainder tables replace its (V, k)
        table (``qr_collisions``, reference :78-84)."""
        return getattr(feat, "qr_collisions", None) is not None and self._owns_table(feat)

    def init(self, generator, device=None) -> dict:
        params = {}
        owners = [f for f in self.feats if self._owns_table(f)]
        for sub, feat in zip(split_rng(generator, max(len(owners), 1)), owners):
            name = f"{self.prefix}{feat.name}_feat_embed"
            if self._is_qr(feat):
                if not isinstance(feat, SparseFeat) or isinstance(feat, SparseValueFeat):
                    raise NotImplementedError(
                        "qr_collisions is supported for single-id sparse features only "
                        f"(got {type(feat).__name__} for {feat.name!r})"
                    )
                q = int(feat.qr_collisions)
                if not 1 < q < feat.feat_size:
                    raise ValueError(f"qr_collisions for {feat.name!r} must be in "
                                     f"(1, feat_size); got {q} vs {feat.feat_size}")
                kq, kr = split_rng(sub, 2)
                params[f"{name}_q"] = glorot_normal(
                    kq, (-(-feat.feat_size // q), self.embedding_size), device=device)
                params[f"{name}_r"] = glorot_normal(kr, (q, self.embedding_size), device=device)
            else:
                params[name] = glorot_normal(
                    sub, (feat.feat_size, self.embedding_size), device=device
                )
            if self.use_bias:
                params[f"{self.prefix}{feat.name}_feat_bias"] = torch.zeros(
                    (feat.feat_size,), dtype=torch.float32, device=device
                )
        return params

    def _qr_rows(self, params, feat, ids):
        """rows(id) = Q[id // q] + R[id % q]: each id keeps a unique composed
        vector in (V/q + q) rows (reference :127-133)."""
        q = int(feat.qr_collisions)
        tq = params[f"{self.prefix}{feat.name}_feat_embed_q"]
        tr = params[f"{self.prefix}{feat.name}_feat_embed_r"]
        return embedding_lookup(tq, ids // q) + embedding_lookup(tr, ids % q)

    def _tables(self, params, feat):
        owner = feat.id_feat.name if isinstance(feat, SequenceFeat) else feat.name
        table = params[f"{self.prefix}{owner}_feat_embed"]
        bias = params.get(f"{self.prefix}{owner}_feat_bias") if self.use_bias else None
        if bias is not None:
            bias = bias[:, None]  # stored 1-D; lookups want (V, 1)
        return table, bias

    def _lookup(self, params, feat, batch):
        """Per-feature lookup -> (embeds (B, n_slots, k), bias (B, n_slots, 1) | None)."""
        if self._is_qr(feat):
            ids = batch[feat.name]
            bias = None
            if self.use_bias:
                bias_vec = params[f"{self.prefix}{feat.name}_feat_bias"]
                bias = embedding_lookup(bias_vec[:, None], ids)[:, None, :]
            return self._qr_rows(params, feat, ids)[:, None, :], bias
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

    def apply(self, params, batch):
        """Every feature's lookup, concatenated along the field axis in the
        feats' order -> (embeds (B, F, k), bias (B, F, 1) | None), the
        reference's ``apply`` (embedding.py:173-213). Plain sparse feats
        take one grouped lookup, whose same-shape tables share the batched
        backward (K3 on CUDA); a QR feat takes its own two lookups."""
        plain = [f for f in self.feats
                 if isinstance(f, SparseFeat) and not isinstance(f, SparseValueFeat)
                 and not self._is_qr(f)]
        embeds_by_name, bias_by_name = {}, {}
        if plain:
            ids = [batch[f.name] for f in plain]
            rows = embedding_lookup_grouped(
                [params[f"{self.prefix}{f.name}_feat_embed"] for f in plain], ids)
            embeds_by_name = {f.name: r[:, None, :] for f, r in zip(plain, rows)}
            if self.use_bias:
                brows = embedding_lookup_grouped(
                    [params[f"{self.prefix}{f.name}_feat_bias"][:, None] for f in plain], ids)
                bias_by_name = {f.name: r[:, None, :] for f, r in zip(plain, brows)}

        embeds, biases = [], []
        for feat in self.feats:
            if feat.name in embeds_by_name:
                e, b = embeds_by_name[feat.name], bias_by_name.get(feat.name)
            else:
                e, b = self._lookup(params, feat, batch)
            embeds.append(e)
            if b is not None:
                biases.append(b)
        bias = torch.cat(biases, dim=1) if (self.use_bias and biases) else None
        return torch.cat(embeds, dim=1), bias

    def apply_dict(self, params, batch) -> dict:
        """Per-feature embeddings keyed by name (DIN's query/key split,
        reference embedding.py:215-219)."""
        return {f.name: self._lookup(params, f, batch)[0] for f in self.feats}

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
                f.name for f in self.feats
                if self._owns_table(f) and not self._is_qr(f) and f.name in in_ctx
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
            name = f"{self.prefix}{feat.name}_feat_embed"
            if self._is_qr(feat):
                total = total + self.l2_reg * (
                    l2_loss(params[f"{name}_q"]) + l2_loss(params[f"{name}_r"]))
            else:
                total = total + self.l2_reg * l2_loss(params[name])
        if stacked_hit:
            total = total + self.l2_reg * l2_loss(sc[1])
        return total
