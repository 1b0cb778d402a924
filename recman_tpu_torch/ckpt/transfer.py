"""Cross-vocabulary warm start: carry trained embeddings into a re-fitted
feature schema.

Production CTR vocabularies drift: retraining refits encoders, id
assignments change, and a naive checkpoint restore would either fail
(shape mismatch) or silently scramble rows. ``warm_start_embeddings``
matches rows by DECODED VALUE — for every feature present in both
schemas, each value in the intersection of the two vocabularies copies
its old embedding (and bias) row into the new id position; genuinely new
values keep their fresh init. The OOV row (id 0) transfers too.

Hashed features transfer whole-table when the bucket count is unchanged
(identical hashing => identical ids); QR features likewise require
matching table shapes. The linear tower's flat ``linear_w`` is model-
specific (per-feature offsets) and deliberately NOT transferred — the
1-D linear weights re-learn in a few steps; the embedding tables are
what carries the signal (and the bytes).

Reference anchor: generalizes checkpoint restore, DeepModel.py:83-86 —
the reference can only restore into the identical variable set.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["warm_start_embeddings"]


def _sparse_with_encoder(feat) -> bool:
    enc = getattr(feat, "encoder", None)
    return enc is not None and getattr(enc, "classes_", None) is not None


def warm_start_embeddings(new_params: dict, new_feat_dict, old_params: dict,
                          old_feat_dict, prefix: str = "") -> dict:
    """Return a copy of ``new_params`` with embedding/bias rows transferred
    from ``old_params`` wherever feature values match by identity.

    ``new_params`` should come from ``model.init_params`` on the NEW
    schema (fresh init supplies rows for new values). Logs a per-feature
    transfer summary; features missing from either side are skipped.
    """
    out = dict(new_params)
    for name, new_feat in new_feat_dict.items():
        old_feat = old_feat_dict.get(name) if hasattr(old_feat_dict, "get") \
            else (old_feat_dict[name] if name in old_feat_dict else None)
        if old_feat is None:
            continue
        embed_key = f"{prefix}{name}_feat_embed"
        bias_key = f"{prefix}{name}_feat_bias"

        # hashed / QR / identical-vocab fast path: same id space => whole
        # arrays carry over when shapes agree
        if not _sparse_with_encoder(new_feat) or not _sparse_with_encoder(old_feat):
            for key in (embed_key, f"{embed_key}_q", f"{embed_key}_r",
                        bias_key):
                if (
                    key in out
                    and key in old_params
                    and np.shape(out[key]) == np.shape(old_params[key])
                ):
                    out[key] = old_params[key]
                    log.info("warm start %s: whole-table transfer", key)
            continue

        if embed_key not in out or embed_key not in old_params:
            # QR-encoded sparse features: transfer only on identical
            # shapes (a different q re-buckets every row)
            for key in (f"{embed_key}_q", f"{embed_key}_r"):
                if (
                    key in out
                    and key in old_params
                    and np.shape(out[key]) == np.shape(old_params[key])
                ):
                    out[key] = old_params[key]
                    log.info("warm start %s: whole-table transfer", key)
            continue

        new_classes = new_feat.encoder.classes_
        old_index = {
            v: i + 1 for i, v in enumerate(old_feat.encoder.classes_.tolist())
        }
        new_ids, old_ids = [0], [0]  # OOV row transfers too
        for new_id, value in enumerate(new_classes.tolist(), start=1):
            old_id = old_index.get(value)
            if old_id is not None:
                new_ids.append(new_id)
                old_ids.append(old_id)
        new_idx = np.asarray(new_ids)
        old_idx = np.asarray(old_ids)

        table = np.array(out[embed_key])
        table[new_idx] = np.asarray(old_params[embed_key])[old_idx]
        out[embed_key] = table
        if bias_key in out and bias_key in old_params:
            bias = np.array(out[bias_key])
            bias[new_idx] = np.asarray(old_params[bias_key])[old_idx]
            out[bias_key] = bias
        log.info(
            "warm start %s: %d/%d rows transferred (%d new values keep "
            "fresh init)", embed_key, len(new_ids),
            len(new_classes) + 1, len(new_classes) + 1 - len(new_ids),
        )
    return out
