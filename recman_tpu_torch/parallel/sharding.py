"""Which params row-shard, and each rank's block of them.

Counterpart of ``recman_tpu/parallel/sharding.py``. A vocabulary array
(``*_feat_embed``, a QR ``*_feat_embed_q``, ``*_feat_bias``, the linear
tower's ``linear_w``) of at least ``row_shard_threshold`` rows splits its
rows over the ``model`` axis; dense towers stay replicated. A spec is a
tuple of axis names per leading dim (the reference's ``PartitionSpec``):
``(MODEL_AXIS, None)`` row-sharded, ``()`` replicated.

Tensor-parallel DNN towers (``tp_dense_threshold``) are not ported yet
(``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import MODEL_AXIS, Sharding

_VOCAB_SUFFIXES = ("_feat_embed", "_feat_embed_q", "_feat_bias", "linear_w")


def _is_vocab_array(name: str) -> bool:
    # a QR quotient table's rows scale with V/q and row-shard like a full
    # table (ids // q address it directly, so tail padding stays unaddressed)
    return name.endswith(_VOCAB_SUFFIXES)


def _refuse_tp(tp_dense_threshold):
    if tp_dense_threshold is not None:
        raise NotImplementedError(
            "tensor-parallel DNN towers (tp_dense_threshold) are not ported yet: "
            "ROADMAP.md queue 1")


def param_specs(params: dict, row_shard_threshold=50_000, tp_dense_threshold=None) -> dict:
    """name -> spec for a flat param dict: a vocabulary array with at least
    ``row_shard_threshold`` rows is ``(MODEL_AXIS, None, ...)``, the rest
    ``()``."""
    _refuse_tp(tp_dense_threshold)
    specs = {}
    for name, value in params.items():
        rows = value.shape[0] if value.ndim else 0
        if _is_vocab_array(name) and value.ndim >= 1 and rows >= row_shard_threshold:
            specs[name] = (MODEL_AXIS, *([None] * (value.ndim - 1)))
        else:
            specs[name] = ()
    return specs


def pad_vocab_for_mesh(feat_size: int, model_axis_size: int) -> int:
    """Round a vocabulary up so rows divide the model axis (padding rows are
    dead weight the OOV row scheme never addresses)."""
    r = feat_size % model_axis_size
    return feat_size if r == 0 else feat_size + (model_axis_size - r)


def _pad_rows(value, rows: int):
    """``value`` zero-padded at the tail to ``rows`` rows."""
    extra = rows - value.shape[0]
    if not extra:
        return value
    if isinstance(value, torch.Tensor):
        return torch.cat([value, value.new_zeros((extra, *value.shape[1:]))])
    return np.pad(np.asarray(value), [(0, extra)] + [(0, 0)] * (value.ndim - 1))


def place_params(params: dict, mesh, specs: dict | None = None, row_shard_threshold=50_000) -> dict:
    """This rank's block of every param, per its spec.

    A row-sharded array whose rows do not divide the model axis (the +1 OOV
    row guarantees this for power-of-two bucket counts) is zero-padded at
    the tail to the next multiple first: ids never address the pad rows,
    their gradients and L2 are exactly zero, so semantics are unchanged.
    Tensors come back as tensors (the block a copy), numpy arrays as
    numpy."""
    specs = specs or param_specs(params, row_shard_threshold)
    model_n = mesh.shape[MODEL_AXIS]
    placed = {}
    for name, value in params.items():
        spec = specs[name]
        if spec:
            value = _pad_rows(value, pad_vocab_for_mesh(value.shape[0], model_n))
            value = Sharding(mesh, spec).local(value)
            if isinstance(value, torch.Tensor):
                value = value.clone()
        placed[name] = value
    return placed


def gather_params(params: dict, mesh, specs: dict) -> dict:
    """The counterpart of reading a sharded ``jax.Array`` back whole: every
    row-sharded param's blocks gathered over the model axis into its padded
    full array (replicated params pass through). Every rank of the model
    group must call it."""
    from .collectives import all_gather

    with torch.no_grad():
        return {k: all_gather(v, mesh, MODEL_AXIS, "gather") if specs[k] else v
                for k, v in params.items()}
