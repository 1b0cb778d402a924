"""Linear (wide) tower parameters and the inference-time weight override.

Counterpart of ``recman_tpu/layers/linear.py``. ``linear_w`` is one 1-D
vector over every linear feature, each feature owning the slice that
starts at its offset; the logit terms are gathers from those slices
(``apply``, or layers/packed.py where the embedding tower shares them):

- SparseFeat        w[offset + id]                 (OOV id 0 contributes)
- SparseValueFeat   w[offset + id] * value
- MultiVal*Feat     sum over ids > 0 of w[offset + id] (OOV excluded)
- DenseFeat         w[offset] * value

The override (reference layers.py:338-345, the "penalize Outdoor by -5"
demo) is an additive vector built from ``feat.weights``, applied when
not training.

Where ``linear_w`` is row-sharded (``ops.embedding.lookup_exchange``), every
term is a lookup into the whole vector at ``offset + id`` (a dense feat's
at ``offset``), all through one masked gather + all-reduce over the model
axis, on both exchanges: a feature's slice of the one sharded vector is
no block of its own, and a dedup capacity sized for one table's ids does
not bound all the features' together.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features import (
    DenseFeat,
    MultiValCsvFeat,
    MultiValSparseFeat,
    SparseFeat,
    SparseValueFeat,
)
from ..ops.embedding import _dedup_ctx, _exchanged, embedding_lookup_grouped
from ..utils import l2_loss


class LinearLayer:
    """Params ``{prefix}linear_w`` (total_size,) and ``{prefix}linear_w0``
    (1,), both zero-initialised (reference layers.py:317-328)."""

    def __init__(self, linear_feats, l2_reg=1e-5, prefix=""):
        self.feats = list(linear_feats)
        self.l2_reg = l2_reg
        self.prefix = prefix
        self.offsets = {}
        offset = 0
        for feat in self.feats:
            self.offsets[feat.name] = offset
            offset += feat.feat_size
        self.total_size = offset

    def init(self, device=None) -> dict:
        return {
            f"{self.prefix}linear_w": torch.zeros(
                (self.total_size,), dtype=torch.float32, device=device
            ),
            f"{self.prefix}linear_w0": torch.zeros(
                (1,), dtype=torch.float32, device=device
            ),
        }

    def override_vector(self) -> np.ndarray:
        """Concat of the per-feature override vectors, aligned to linear_w."""
        return np.concatenate(
            [np.asarray(f.weights, dtype=np.float32) for f in self.feats]
        )

    def weights(self, params, override=None) -> torch.Tensor:
        """``linear_w`` plus the override (zero-padded to its length; on a
        row-sharded ``linear_w`` block, the override's same rows)."""
        w = params[f"{self.prefix}linear_w"]
        if override is None:
            return w
        override = override.to(device=w.device, dtype=w.dtype)
        start = 0
        if _exchanged(w) is not None:
            start = _dedup_ctx().mesh.model_index * w.shape[0]
        override = override[start: start + w.shape[0]]
        if override.shape[0] < w.shape[0]:
            override = torch.cat(
                [override, override.new_zeros(w.shape[0] - override.shape[0])]
            )
        return w + override

    def _exchanged_rows(self, w, dense, ids_list, kinds):
        """Every term's weights through one psum exchange on the row-sharded
        ``linear_w`` block ``w``: (dense weights (B,) each, sparse rows)."""
        from ..parallel.shard_lookup import _psum_rows

        b = ids_list[0].shape[0] if ids_list else dense[0][1].shape[0]
        gids = [torch.full((b,), off, dtype=torch.int64, device=w.device) for off, _ in dense]
        gids += [ids.long() + self.offsets[feat.name] for feat, ids in zip(kinds, ids_list)]
        flat = _psum_rows([w[:, None]], [torch.cat([g.reshape(-1) for g in gids])],
                          _dedup_ctx().mesh, "linear")[0][:, 0]
        parts = list(flat.split([g.numel() for g in gids]))
        dense_w = parts[:len(dense)]
        rows = [p.reshape(*ids.shape, 1) for p, ids in zip(parts[len(dense):], ids_list)]
        return dense_w, rows

    def apply(self, params, batch, training=True, override=None):
        """The linear logit (B, 1) (reference linear.py:74-130). Each
        sparse feature gathers from its own static slice of ``linear_w``,
        all through one grouped lookup; ``override`` applies only when not
        training."""
        w = self.weights(params, None if training else override)[:, None]
        dense, slices, ids_list, kinds = [], [], [], []
        for feat in self.feats:
            off = self.offsets[feat.name]
            if isinstance(feat, DenseFeat):
                dense.append((off, batch[feat.name]))
                continue
            slices.append(w[off: off + feat.feat_size])
            kinds.append(feat)
            if isinstance(feat, (MultiValCsvFeat, MultiValSparseFeat)):
                ids_list.append(batch[feat.name].clamp_min(0))
            elif isinstance(feat, (SparseFeat, SparseValueFeat)):
                ids_list.append(batch[feat.name])
            else:
                raise NotImplementedError(type(feat))

        if _exchanged(params[f"{self.prefix}linear_w"]) is not None:
            dense_w, looked_up = self._exchanged_rows(w[:, 0], dense, ids_list, kinds)
        else:
            dense_w = [w[off, 0] for off, _ in dense]
            looked_up = embedding_lookup_grouped(slices, ids_list)
        terms = [dw * value for dw, (_, value) in zip(dense_w, dense)]
        for feat, rows in zip(kinds, looked_up):
            if isinstance(feat, SparseValueFeat):
                terms.append(rows[:, 0] * batch[feat.value_key])
            elif isinstance(feat, SparseFeat):
                terms.append(rows[:, 0])
            else:  # multi-val: the OOV id 0 is excluded (reference utils.py:106-107)
                terms.append((rows[:, :, 0] * (batch[feat.name] > 0).to(rows.dtype)).sum(dim=1))
        # summed in the reference's order: dense terms, then the gathers
        logit = terms[0]
        for t in terms[1:]:
            logit = logit + t
        return (logit + params[f"{self.prefix}linear_w0"])[:, None]

    def l2(self, params):
        """Reference layers.py:349-354 / 441-446."""
        return self.l2_reg * l2_loss(params[f"{self.prefix}linear_w"])


# the reference's name for the same layer (recman_tpu/layers/linear.py:136)
SparseLinearLayer = LinearLayer
