"""Packed embedding + linear lookup: one gather per feature.

Counterpart of ``recman_tpu/layers/packed.py`` — the stacked-storage
branch (:128-164), the split branch (:165-182), the concat-then-gather
branch (:183-216) and the per-type postprocessing (:218-288), taken in
the reference's order: stacked, then split, then concat. Each
feature that both towers use gets a packed [table | bias | w_slice]
matrix (V, k [+1] +1), so one row gather serves both. Semantics are those
of the separate towers:

- the embedding combine masks ids >= 0 (sqrtn), the linear term ids > 0
- SparseValueFeat scales both parts by the value
- the inference-time linear override applies to the w column only, and
  never in training
- dense features only contribute to the linear logit

Under ``ops.embedding.stacked_tables`` (the stacked train step) the
packable tables come from one (T, V, k) leaf and their rows from
``packed_lookup_stacked_split`` (per-table [stack[i] | w] rows) or, with
``ops.embedding.STACKED_SPLIT_CONCAT = False``, ``packed_lookup_stacked``
(one (T, V, k + 1) concat); either backward is one K3 launch over all
tables. Under ``ops.embedding.split_lookup("on")`` the table rows and the
vector columns are gathered apart (``packed_lookup_grouped``), with no
packed matrix; its backward is K7 or K3 per same-shape group. Otherwise
the packed matrices go through ``embedding_lookup_grouped``, whose
backward (with the fused backward active, the default on CUDA) is one
batched K3 launch for each group of same-shape tables and, under
``grad_kernel("segmat")``, one K6 launch for each table of its own shape.
Rows stay float32. The reference's bf16 packed rows (its
``PACKED_FWD_BF16`` gate) are on only on its TPU path; the port keeps f32
until that choice is measured on the GPU.

Under an exchange (``ops.embedding.lookup_exchange``, the row-sharded
steps) nothing is packed (reference :101-115): a packed [table | w]
temporary is no row-sharded block, so the towers run apart
(``EmbeddingLayer.apply``, ``LinearLayer.apply``) and each block takes the
exchange.

QR features (``qr_collisions``) have no single (V, k) table to pack and
take the unpacked lookups (reference :60-62). When any packable table is
an int8 ``ops.embedding.QuantTable`` (quantized serving, reference
:101-115) nothing is packed: an f32 packed concat would undo the
gather-then-dequantize.
"""

from __future__ import annotations

import torch

from ..features import (
    DenseFeat,
    MultiValCsvFeat,
    MultiValSparseFeat,
    SequenceFeat,
    SparseFeat,
    SparseValueFeat,
)
from ..ops import embedding as emb_ops
from ..ops.embedding import (
    QuantTable,
    _split_lookup_active,
    _stacked_ctx,
    embedding_lookup,
    embedding_lookup_grouped,
    packed_lookup_grouped,
    packed_lookup_stacked,
    packed_lookup_stacked_split,
)


class PackedEmbeddingLinear:
    """Fused apply over an EmbeddingLayer and a LinearLayer."""

    def __init__(self, embeddings, linear):
        self.embeddings = embeddings
        self.linear = linear
        linear_names = {f.name for f in linear.feats}
        self.packable = [
            f
            for f in embeddings.feats
            if f.name in linear_names and not isinstance(f, SequenceFeat)
            and getattr(f, "qr_collisions", None) is None
        ]

    def stackable(self):
        """Ordered name tuple of the packable feats eligible for stacked
        (T, V, k) table storage, or None (reference :66-81): every
        packable feat takes 1-D ids (no multi-val), all share one
        feat_size, and the embedding tower has no bias."""
        if self.embeddings.use_bias or not self.packable:
            return None
        if len({f.feat_size for f in self.packable}) != 1:
            return None
        if any(isinstance(f, (MultiValCsvFeat, MultiValSparseFeat)) for f in self.packable):
            return None
        return tuple(f.name for f in self.packable)

    def apply(self, params, batch, training=False, override=None):
        """Returns (feat_embeds (B, F, k), feat_bias (B, F, 1) | None,
        linear_logit (B, 1)). The override is ignored in training."""
        emb = self.embeddings
        lin = self.linear
        if emb_ops._dedup_ctx() is not None:
            feat_embeds, feat_bias = emb.apply(params, batch)
            return feat_embeds, feat_bias, lin.apply(params, batch, training, override)
        k = emb.embedding_size
        use_bias = emb.use_bias
        w = lin.weights(params, None if training else override)
        quant = any(isinstance(params.get(f"{emb.prefix}{f.name}_feat_embed"), QuantTable)
                    for f in self.packable)
        packable = [] if quant else self.packable
        packable_names = {f.name for f in packable}

        embeds_by_name, bias_by_name = {}, {}
        linear_logit = params[f"{lin.prefix}linear_w0"]

        ids_mats = []
        for feat in packable:
            ids = batch[feat.name]
            if isinstance(feat, (MultiValCsvFeat, MultiValSparseFeat)):
                ids = ids.clamp_min(0)
            ids_mats.append(ids)

        sc = _stacked_ctx()
        if (
            sc is not None
            and not use_bias
            and tuple(f.name for f in packable) == sc[0]
        ):
            # stacked (T, V, k) storage: [stack[i] | w] rows, one batched
            # sort / permute / K3 backward into the stacked leaf
            v = packable[0].feat_size
            w_cols = torch.stack([
                w[lin.offsets[f.name]: lin.offsets[f.name] + v] for f in packable
            ])  # (T, V)
            if emb_ops.STACKED_SPLIT_CONCAT:
                rows_list = packed_lookup_stacked_split(sc[1][:, :v], w_cols, ids_mats)
            else:
                packed = torch.cat([sc[1][:, :v], w_cols[:, :, None]], dim=2)
                rows_list = packed_lookup_stacked(packed, ids_mats)
        elif _split_lookup_active(w.device):
            # the split form: table rows and vector columns gathered apart,
            # no (V, k + m) packed matrix built
            tables, vec_cols = [], []
            for feat in packable:
                tables.append(params[f"{emb.prefix}{feat.name}_feat_embed"][: feat.feat_size])
                vv = []
                if use_bias:
                    vv.append(params[f"{emb.prefix}{feat.name}_feat_bias"][: feat.feat_size])
                off = lin.offsets[feat.name]
                vv.append(w[off: off + feat.feat_size])
                vec_cols.append(tuple(vv))
            rows_list = packed_lookup_grouped(tables, vec_cols, ids_mats)
        else:
            # phase 1: each feature's packed [table | bias | w] matrix
            packed_mats = []
            for feat in packable:
                # tables may carry tail padding; slice to the logical vocab
                table = params[f"{emb.prefix}{feat.name}_feat_embed"]
                cols = [table[: feat.feat_size]]
                if use_bias:
                    cols.append(
                        params[f"{emb.prefix}{feat.name}_feat_bias"][: feat.feat_size, None]
                    )
                off = lin.offsets[feat.name]
                cols.append(w[off: off + feat.feat_size][:, None])
                packed_mats.append(torch.cat(cols, dim=1))  # (V, k [+1] +1)
            # phase 2: one gather per feature
            rows_list = embedding_lookup_grouped(packed_mats, ids_mats)

        # phase 3: per-type postprocessing
        for feat, rows in zip(packable, rows_list):
            if isinstance(feat, (SparseFeat, SparseValueFeat)):
                if isinstance(feat, SparseValueFeat):
                    rows = rows * batch[feat.value_key][:, None]
                embeds_by_name[feat.name] = rows[:, None, :k]
                if use_bias:
                    bias_by_name[feat.name] = rows[:, None, k: k + 1]
                linear_logit = linear_logit + rows[:, -1:]
            else:  # multi-val
                ids = batch[feat.name]  # (B, L)
                present = (ids >= 0).to(rows.dtype)
                combined = torch.einsum("blw,bl->bw", rows, present)
                count = present.sum(dim=1, keepdim=True)
                sqrtn = combined * torch.where(
                    count > 0, 1.0 / torch.sqrt(count.clamp_min(1.0)), 0.0
                )
                embeds_by_name[feat.name] = sqrtn[:, None, :k]
                if use_bias:
                    bias_by_name[feat.name] = sqrtn[:, None, k: k + 1]
                # linear: plain sum over ids > 0 (OOV excluded)
                pos = (ids > 0).to(rows.dtype)
                linear_logit = linear_logit + torch.einsum(
                    "bl,bl->b", rows[:, :, -1], pos
                )[:, None]

        # the unpacked rest of the embedding tower (sequence feats, feats
        # outside the linear selector)
        embeds, biases = [], []
        for feat in emb.feats:
            if feat.name in packable_names:
                e = embeds_by_name[feat.name]
                b = bias_by_name.get(feat.name)
            else:
                e, b = emb._lookup(params, feat, batch)
            embeds.append(e)
            if b is not None:
                biases.append(b)
        feat_embeds = torch.cat(embeds, dim=1)
        feat_bias = torch.cat(biases, dim=1) if (use_bias and biases) else None

        # the unpacked rest of the linear tower (dense feats and sparse
        # feats outside the embedding tower)
        for feat in lin.feats:
            off = lin.offsets[feat.name]
            if isinstance(feat, DenseFeat):
                linear_logit = linear_logit + (w[off] * batch[feat.name])[:, None]
            elif feat.name not in packable_names:
                w_f = w[off: off + feat.feat_size][:, None]
                if isinstance(feat, SparseValueFeat):
                    linear_logit = linear_logit + (
                        embedding_lookup(w_f, batch[feat.name])[:, 0]
                        * batch[feat.value_key]
                    )[:, None]
                elif isinstance(feat, SparseFeat):
                    linear_logit = linear_logit + embedding_lookup(w_f, batch[feat.name])
                elif isinstance(feat, (MultiValCsvFeat, MultiValSparseFeat)):
                    ids = batch[feat.name]
                    mask = (ids > 0).to(w.dtype)
                    rows = embedding_lookup(w_f, ids.clamp_min(0))[:, :, 0]
                    linear_logit = linear_logit + (rows * mask).sum(dim=1)[:, None]

        return feat_embeds, feat_bias, linear_logit
