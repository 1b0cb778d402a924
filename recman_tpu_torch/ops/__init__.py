"""Ops of the port: plain PyTorch functions and the wrappers of the
hand-written CUDA kernels (sources in ``recman_tpu_torch/csrc``)."""

from .cin_chain import (
    chain_supported,
    cin_chain_bwd,
    cin_chain_bwd_reference,
    cin_chain_fm,
    cin_chain_fm_reference,
    cin_chain_fwd,
)
from .cin_interact import cin_interact
from .embedding import (
    embedding_lookup,
    embedding_lookup_grouped,
    packed_lookup_stacked_split,
    stacked_tables,
)
from .segment_matmul import segment_matmul_from_sorted_batched, segment_matmul_reference

__all__ = [
    "chain_supported",
    "cin_chain_bwd",
    "cin_chain_bwd_reference",
    "cin_chain_fm",
    "cin_chain_fm_reference",
    "cin_chain_fwd",
    "cin_interact",
    "embedding_lookup",
    "embedding_lookup_grouped",
    "packed_lookup_stacked_split",
    "segment_matmul_from_sorted_batched",
    "segment_matmul_reference",
    "stacked_tables",
]
