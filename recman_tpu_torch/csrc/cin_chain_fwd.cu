// K1: the whole CIN tower forward in one launch, with or without saving
// the fmaps for the backward.
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
// operations bound the save variant too.
// This simple design runs on the CUDA cores: 1.56 ms at that geometry on
// an H100 80GB HBM3 at a 700 W power limit (chip_smoke.py), about 30x the
// bound. Tensor cores (mma.sync / wgmma, bf16 in, f32 sums) keep the same
// rounding and are the next step.

#include "cin_chain_fwd.cuh"

// Shared memory the kernel needs for a geometry, in bytes.
extern "C" int cin_chain_fwd_smem_bytes(int h0, int n_layers, const int* units) {
  return chain_fwd_smem_bytes(h0, n_layers, units);
}

// Launches K1 on `stream`. x0c (h0, bd) f32; w[l] (h0*hk_l, o_pad_l) bf16
// with o_pad_l = roundup(units[l], 8) and padding columns zero; b[l]
// (units[l],) f32; out[l] (bd/d, F_l) f32; fmap null (no fmaps saved) or
// fmap[l] (units[l], bd) f32. act: 0 identity, 1 relu, 2 leaky_relu.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for a geometry outside the kernel's range).
extern "C" int cin_chain_fwd(const void* x0c, int h0, int bd, int d, int n_layers,
                             const int* units, const void* const* w,
                             const void* const* b, void* const* out,
                             void* const* fmap, int act, void* stream) {
  return chain_fwd_launch(x0c, h0, bd, d, n_layers, units, w, b, out, fmap, nullptr, act,
                          static_cast<cudaStream_t>(stream));
}
