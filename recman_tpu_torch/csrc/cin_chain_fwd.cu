// K1: the whole CIN tower forward in one launch, with or without saving
// the fmaps for the backward, on the tensor cores.
//
// Replaces the TPU kernel recman_tpu/ops/cin_chain.py:_chain_fwd_kernel
// (launched from _chain_fwd_pallas). Bound to PyTorch through a plain C
// interface (ctypes); the wrapper is recman_tpu_torch/ops/cin_chain.py.
// The kernel itself, what it computes and its design are in
// cin_chain_fwd.cuh, which K2's recompute form (cin_chain_bwd.cu) shares.
// Without `fmap` (serving, and the training forward of K2's recompute
// form) only the pooled outputs are written and the fmaps never leave
// the block. With it (the reference's CHAIN_SAVE_FMAPS, training) every
// layer's whole fmap, activated and not rounded, is also written to
// fmap_i (O_i, B*D) f32 for K2's save form.
//
// Bound on an H100 SXM: operations. At the serving geometry (H0 = 26,
// units (100, 100), D = 16, B = 8192) the two contractions are 51.8 GFLOP
// of bf16 products, 52 us at the 989 TFLOP/s bf16 tensor-core peak; the
// bytes (13.6 MB of x0c in, 4.9 MB pooled out) take 5.5 us at 3.35 TB/s;
// saving the fmaps adds 104.9 MB (2 x 100 x 131,072 x 4 B), 31 us, so
// operations bound the save variant too. Padding (Hk 26 -> 32 and 50 ->
// 56, O 100 -> 112) makes the tensor cores do about 1.3x the function's
// products.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chain_readings.py
// timing): 0.451-0.455 ms at that geometry (114 TFLOP/s of the function's
// products; the save form 0.458-0.462 ms) and 3.41 ms saving at B =
// 65,536 (122 TFLOP/s), against 1.63 and 12.58 ms for the CUDA-core
// design this replaces. The
// bare bf16 contraction on a prebuilt z (torch.matmul) takes 0.286 ms:
// what is left over it is building z in registers, the split sums (0.424
// ms without them, chain_readings.py) and the epilogue's passes over
// shared memory; wgmma is the next step.

#include "cin_chain_fwd.cuh"

// Shared memory the kernel needs for a geometry, in bytes.
extern "C" int cin_chain_fwd_smem_bytes(int h0, int n_layers, const int* units) {
  return chain_fwd_smem_bytes(h0, n_layers, units);
}

// Bytes of device memory cin_chain_fwd needs for its table of layers.
extern "C" int cin_chain_fwd_table_bytes(int n_layers) { return chain_fwd_table_bytes(n_layers); }

// Launches K1 on `stream`. x0c (h0, bd) f32; w[l] (units[l], kp_l) bf16
// in K4's layout (cin_chain_fwd.cuh: chain_fwd_launch); b[l] (units[l],)
// f32; out[l] (bd/d, F_l) f32; fmap null (no fmaps saved) or fmap[l]
// (units[l], bd) f32. act: 0 identity, 1 relu, 2 leaky_relu. table:
// cin_chain_fwd_table_bytes(n_layers) bytes of device memory. Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for a
// geometry outside the kernel's range).
extern "C" int cin_chain_fwd(const void* x0c, int h0, int bd, int d, int n_layers,
                             const int* units, const void* const* w,
                             const void* const* b, void* const* out,
                             void* const* fmap, int act, void* table, void* stream) {
  return chain_fwd_launch(x0c, h0, bd, d, n_layers, units, w, b, out, fmap, nullptr, act, table,
                          static_cast<cudaStream_t>(stream));
}
