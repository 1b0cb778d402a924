"""Ops of the port: plain PyTorch functions and the wrappers of the
hand-written CUDA kernels (sources in ``recman_tpu_torch/csrc``)."""

from .cin_chain import (
    chain_supported,
    cin_chain_bwd,
    cin_chain_bwd_recompute,
    cin_chain_bwd_recompute_reference,
    cin_chain_bwd_reference,
    cin_chain_fm,
    cin_chain_fm_reference,
    cin_chain_fwd,
)
from .cin_interact import cin_interact_fm, pallas_cin
from .embedding import (
    QuantTable,
    embedding_lookup,
    embedding_lookup_grouped,
    embedding_lookup_multi,
    fused_grad,
    grad_kernel,
    packed_lookup_grouped,
    packed_lookup_stacked,
    packed_lookup_stacked_split,
    quantize_table_int8,
    split_lookup,
    stacked_tables,
)
from .segment_matmul import (
    segment_matmul_from_sorted,
    segment_matmul_from_sorted_batched,
    segment_matmul_from_sorted_batched_vk,
    segment_matmul_reference,
    segment_matmul_rows_reference,
    segment_matmul_vk_reference,
)

__all__ = [
    "QuantTable",
    "chain_supported",
    "cin_chain_bwd",
    "cin_chain_bwd_recompute",
    "cin_chain_bwd_recompute_reference",
    "cin_chain_bwd_reference",
    "cin_chain_fm",
    "cin_chain_fm_reference",
    "cin_chain_fwd",
    "cin_interact_fm",
    "embedding_lookup",
    "embedding_lookup_grouped",
    "embedding_lookup_multi",
    "fused_grad",
    "grad_kernel",
    "packed_lookup_grouped",
    "packed_lookup_stacked",
    "packed_lookup_stacked_split",
    "pallas_cin",
    "quantize_table_int8",
    "segment_matmul_from_sorted",
    "segment_matmul_from_sorted_batched",
    "segment_matmul_from_sorted_batched_vk",
    "segment_matmul_reference",
    "segment_matmul_rows_reference",
    "segment_matmul_vk_reference",
    "split_lookup",
    "stacked_tables",
]
