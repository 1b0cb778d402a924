"""Which params shard over the model axis, and each rank's block of them.

Counterpart of ``recman_tpu/parallel/sharding.py``. A spec is a tuple of
axis names per leading dim (the reference's ``PartitionSpec``), ``()``
replicated:

- a vocabulary array (``*_feat_embed``, a QR ``*_feat_embed_q``,
  ``*_feat_bias``, the linear tower's ``linear_w``) of at least
  ``row_shard_threshold`` rows splits its rows, ``(MODEL_AXIS, None)``;
- with ``tp_dense_threshold``, a DNN tower's ``dnn_layer_{i}_weights`` of
  at least that many elements is tensor-parallel in Megatron's
  alternation: column-sharded ``(None, MODEL_AXIS)`` for even ``i``,
  row-sharded for odd ``i``; a column layer's bias is ``(MODEL_AXIS,)``
  when its own size crosses the threshold (usually not), every other bias
  replicated (``layers/dnn.py`` runs the layers so);
- everything else is replicated.

``param_specs`` gives the reference's specs. A tensor-parallel dim that
does not divide the model axis falls back to replicated; the reference
does so when it places the leaf (``place_params``), the port once, in
``resolve_specs``, whose specs the trainer keeps and every consumer (the
DNN, L2, the gradient sums, the loss, ``gather_params``, checkpoints)
reads, so a replicated leaf is never taken for a block.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .mesh import MODEL_AXIS, Sharding

_VOCAB_SUFFIXES = ("_feat_embed", "_feat_embed_q", "_feat_bias", "linear_w")
_DNN_LEAF = re.compile(r"dnn_layer_(\d+)_(weights|bias)$")


def _is_vocab_array(name: str) -> bool:
    # a QR quotient table's rows scale with V/q and row-shard like a full
    # table (ids // q address it directly, so tail padding stays unaddressed)
    return name.endswith(_VOCAB_SUFFIXES)


def param_specs(params: dict, row_shard_threshold=50_000, tp_dense_threshold=None) -> dict:
    """name -> spec for a flat param dict (module docstring), the
    reference's: before the tensor-parallel fallback."""
    specs = {}
    for name, value in params.items():
        rows = value.shape[0] if value.ndim else 0
        if _is_vocab_array(name) and value.ndim >= 1 and rows >= row_shard_threshold:
            specs[name] = (MODEL_AXIS, *([None] * (value.ndim - 1)))
            continue
        m = _DNN_LEAF.search(name) if tp_dense_threshold is not None else None
        if m and int(np.prod(value.shape)) >= tp_dense_threshold:
            column = int(m.group(1)) % 2 == 0  # Megatron alternation
            if m.group(2) == "weights":
                specs[name] = (None, MODEL_AXIS) if column else (MODEL_AXIS, None)
            else:
                specs[name] = (MODEL_AXIS,) if column else ()
            continue
        specs[name] = ()
    return specs


def block_dim(spec) -> int | None:
    """The dim a spec splits over the model axis, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def resolve_specs(specs: dict, params: dict, model_axis_size: int) -> dict:
    """``specs`` with every tensor-parallel leaf whose split dim does not
    divide the model axis replicated (reference ``place_params``, :110-115);
    vocabulary arrays keep their specs: their rows pad."""
    out = {}
    for name, spec in specs.items():
        dim = block_dim(spec)
        if dim is not None and not _is_vocab_array(name) and \
                params[name].shape[dim] % model_axis_size:
            spec = ()
        out[name] = spec
    return out


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
    model_n = mesh.shape[MODEL_AXIS]
    specs = specs or resolve_specs(param_specs(params, row_shard_threshold), params, model_n)
    placed = {}
    for name, value in params.items():
        spec = specs[name]
        if spec:
            if _is_vocab_array(name):
                value = _pad_rows(value, pad_vocab_for_mesh(value.shape[0], model_n))
            value = Sharding(mesh, spec).local(value)
            if isinstance(value, torch.Tensor):
                value = value.clone()
        placed[name] = value
    return placed


def gather_params(params: dict, mesh, specs: dict) -> dict:
    """The counterpart of reading a sharded ``jax.Array`` back whole: every
    blocked param's blocks gathered over the model axis on its spec's dim
    into its full (row-padded) array; replicated params and optax's
    MaskedNode pass through. Every rank of the model group must call it."""
    from .collectives import gather_blocks

    out = {}
    with torch.no_grad():
        for k, v in params.items():
            dim = block_dim(specs[k])
            if dim is not None and isinstance(v, torch.Tensor) and v.dim() > dim:
                v = gather_blocks(v, mesh, MODEL_AXIS, dim, "gather")
            out[k] = v
    return out


def global_shape(shape, spec, model_axis_size: int) -> tuple:
    """The full shape of a block of ``shape`` placed by ``spec``."""
    dim = block_dim(spec)
    shape = tuple(shape)
    if dim is None or len(shape) <= dim:
        return shape
    return shape[:dim] + (shape[dim] * model_axis_size,) + shape[dim + 1:]
