// K5: one CIN layer's interaction backward, field-major, on the tensor cores.
//
// Replaces the TPU kernel recman_tpu/ops/cin_interact.py:_bwd_kernel
// (launched from _pallas_bwd). Bound to PyTorch through a plain C
// interface (ctypes); the wrapper is recman_tpu_torch/ops/cin_interact.py.
//
// What it computes, from x0c (H0, B*D), xkc (Hk, B*D), W (H0*Hk, O) and
// the cotangent g (O, B*D) f32, with gb = bf16(g) (reference :157-205):
//   u[h*Hk+m, n] = sum_o bf16(W[h*Hk+m, o]) * gb[o, n]      (f32 sums)
//   dx0[h, n]    = sum_m u[h*Hk+m, n] * xk[m, n]            (xk in f32)
//   dxk[m, n]    = sum_h u[h*Hk+m, n] * x0[h, n]            (x0 in f32)
//   dW[x, o]     = sum_n z[x, n] * gb[o, n],  z = bf16(bf16(x0) * bf16(xk))
// These are one layer of K2's formulas (csrc/cin_chain_bwd.cu) without
// the activation's derivative and db. Every bf16 rounding above is one
// the reference makes, at the same place.
//
// Bound on an H100 SXM: operations. At the xDeepFM paper's Criteo layer
// (H0 = 26, Hk = 100, O = 200, B*D = 40,960) u and dW each take 42.6
// GFLOP of bf16 products, 85.2 GFLOP in all: 86 us at the 989 TFLOP/s
// bf16 tensor-core peak. The bytes (g 32.8 MB, x0c and xkc in, dx0 and
// dxk out, 41.0 MB, W and dW 4.2 MB) take 23 us at 3.35 TB/s. So both
// products go to the tensor cores: mma.sync.m16n8k16 with bf16 operands
// and f32 sums (tensor_core.cuh), operands staged with cp.async.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chain_readings.py
// timing): 0.80 ms at that layer (106 TFLOP/s) with its sums split
// (cin_bwd_mma.cuh), 0.67 with one accumulation (phase 1 0.41 ms of
// 0.70 then, a chip_smoke.py profile). What holds
// it above the bound is shared memory and latency, not the tensor pipe:
// mma.sync takes both operands from registers, so every fragment is
// ldmatrix'ed (phase 1: W_h by each of the 8 column groups, about 0.65
// ldmatrix.x4 a product), and a warp's loads and products of a k-step
// run in order. wgmma, reading B from shared memory, is the next step.
//
// Design. Phase 1's field loop and phase 2 are shared with K2
// (cin_bwd_mma.cuh). The TPU kernel carries dW in VMEM across its
// sequential grid.
// Blocks on the card run in no order, so the work splits into three
// launches with no atomics, each sum in a fixed order, and two calls are
// bit-equal:
// 1. cin_interact_bwd_cols: everything but dW is local to a column. A
//    block owns 128 columns and runs 16 warps: 8 groups of 16 columns,
//    each split in two halves of Hk's n8 tiles, so that u, dxk and xk of a
//    thread fit its 128 registers. The block stages bf16(g) for its
//    columns once (O x 128 bf16, 51 KB at O 200, 131 KB at O 512) and
//    writes it, bf16(x0) and bf16(xk) to a (O + H0 + Hk, B*D rounded up to
//    64) bf16 scratch for phase 2. For each field h it forms u_h^T
//    (columns x Hk8) = gb^T (columns x O16) . W_h^T (O16 x Hk8): M the
//    columns, N = Hk rounded up to 8, K = O rounded up to 16. A (gb^T)
//    comes from the staged g through ldmatrix.trans; B (W_h) streams
//    through a 3-stage cp.async ring of the wrapper's layout Wp[h*Hk8 +
//    m][o] = bf16(W[h*Hk+m, o]), a whole field a stage where shared memory
//    allows (O 200 at Hk 100), else the widest slice of a multiple of 64
//    maps that fits. A k-step loads
//    all its fragments before its products, so the loads overlap. The fold
//    runs on the accumulator fragments, in f32: dx0[h, n] is an in-thread
//    sum over the thread's m, a shuffle sum over the 4 threads that share
//    the column, and the sum of the two halves' partials in shared memory,
//    in that order; dxk[m, n] += u * x0[h, n] stays in registers, in the
//    same fragment layout, across every h and is stored once.
// 2. cin_interact_bwd_dw: dW = z . gb^T. M = the X rows of dW, N = the
//    maps, K = B*D. A block owns 128 rows x 128 maps and one split of the
//    columns; 8 warps as 4 (rows) x 2 (maps), each 32 x 64. Each 64-column
//    slice of the x0 rows its z rows need, of xk, and of gb's 128 maps
//    streams through a 3-stage cp.async ring; every thread builds its A
//    fragment of z in registers from two 32-bit loads and one bf16x2
//    multiply, with its rows' (h, m) offsets computed once per block (no
//    divide in the loop); B comes through ldmatrix. Each split writes its
//    own partial dW.
// 3. cin_interact_bwd_reduce: dW = the sum of the split partials, in
//    split order.
// - Padding reads zero: W's rows past Hk and maps past O, g's maps past O
//   and columns past B*D, the scratch's columns past B*D. Rows and maps
//   past X and O and columns past B*D are not stored.
//
// Geometry taken (the wrapper checks and raises outside it): any H0 >= 1
// and B*D >= 1, 1 <= Hk <= 128, 1 <= O <= 512.

#include "cin_bwd_mma.cuh"

namespace {

using cinbwd::kCols;
using cinbwd::kColsThreads;
using cinbwd::kGStride;
using cinbwd::kMaxSmem;
using cinbwd::kSlice;
using cinbwd::kStages;
using cinbwd::round_up;

struct ColsArgs {
  const float* x0;             // (h0, bd) f32
  const float* xk;             // (hk, bd) f32
  const __nv_bfloat16* wp;     // (h0*hk8, o64) bf16: [h*hk8 + m][o] = bf16(W[h*hk+m, o])
  const float* g;              // (o, bd) f32
  __nv_bfloat16* gb;           // (o, bdp) bf16 scratch: bf16(g)
  __nv_bfloat16* x0b;          // (h0, bdp) bf16 scratch: bf16(x0)
  __nv_bfloat16* xkb;          // (hk, bdp) bf16 scratch: bf16(xk)
  float* dx0;                  // (h0, bd) f32
  float* dxk;                  // (hk, bd) f32
  int h0, hk, hk8, o, o16, o64, bd, bdp;
  int sw;                      // maps per W slice of the ring, a multiple of 64
};

// NTW: n8 tiles of u a warp holds, at least half of hk8 / 8
template <int NTW>
__global__ void __launch_bounds__(kColsThreads, 1) cin_interact_bwd_cols(const ColsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem);  // o16 x kGStride: gb[o][n]
  float* red = reinterpret_cast<float*>(gs + a.o16 * kGStride);  // 2 x 2 x kCols: dx0 halves
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(red + 4 * kCols);  // kStages x hk8 x ws_stride

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kCols;
  const cinbwd::WRing w(ring, a.wp, a.h0, a.hk8, a.o16, a.o64, a.sw);
  w.prologue();  // W's first slices load while g, x0 and xk are staged

  // bf16 copies: g to shared memory and the scratch, x0 and xk to the
  // scratch; zero past O and B*D. Each thread keeps 4 loads of 16 bytes in
  // flight before it stores.
  const int g_quads = a.o16 * (kCols / 4);
  for (int i0 = tid; i0 < g_quads; i0 += 4 * kColsThreads) {
    float4 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + e * kColsThreads, r = i >> 5;
      v[e] = i < g_quads && r < a.o ? tc::load4(a.g + (size_t)r * a.bd, col0 + (i & 31) * 4, a.bd)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + e * kColsThreads, r = i >> 5, n = (i & 31) * 4;
      if (i >= g_quads) break;
      const uint2 b = tc::pack_bf16x4(v[e]);
      *reinterpret_cast<uint2*>(gs + r * kGStride + n) = b;
      if (r < a.o && col0 + n < a.bdp)
        *reinterpret_cast<uint2*>(a.gb + (size_t)r * a.bdp + col0 + n) = b;
    }
  }
  const int x_quads = (a.h0 + a.hk) * (kCols / 4);
  for (int i0 = tid; i0 < x_quads; i0 += 4 * kColsThreads) {
    float4 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + e * kColsThreads, r = i >> 5;
      const float* row = r < a.h0 ? a.x0 + (size_t)r * a.bd : a.xk + (size_t)(r - a.h0) * a.bd;
      v[e] = i < x_quads ? tc::load4(row, col0 + (i & 31) * 4, a.bd)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + e * kColsThreads, r = i >> 5, col = col0 + (i & 31) * 4;
      if (i >= x_quads) break;
      if (col >= a.bdp) continue;
      __nv_bfloat16* row = r < a.h0 ? a.x0b + (size_t)r * a.bdp : a.xkb + (size_t)(r - a.h0) * a.bdp;
      *reinterpret_cast<uint2*>(row + col) = tc::pack_bf16x4(v[e]);
    }
  }

  // warp = (half, column group): 16 columns, rows g and g + 8 of its
  // fragments; half 0 holds u's n8 tiles [0, t0), half 1 [t0, nt)
  const cinbwd::ColsThread t = cinbwd::cols_thread(a.hk8, a.bd);
  const int q = t.q, j0 = t.j0, ntw = t.ntw, ca = t.ca, cb = t.cb;
  const bool va = t.va, vb = t.vb;
  float xkr[NTW][4], dxk[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int m = 8 * (j0 + j) + 2 * q;
    const bool on = j < ntw;
    xkr[j][0] = on && va && m < a.hk ? a.xk[(size_t)m * a.bd + ca] : 0.0f;
    xkr[j][1] = on && va && m + 1 < a.hk ? a.xk[(size_t)(m + 1) * a.bd + ca] : 0.0f;
    xkr[j][2] = on && vb && m < a.hk ? a.xk[(size_t)m * a.bd + cb] : 0.0f;
    xkr[j][3] = on && vb && m + 1 < a.hk ? a.xk[(size_t)(m + 1) * a.bd + cb] : 0.0f;
    dxk[j][0] = dxk[j][1] = dxk[j][2] = dxk[j][3] = 0.0f;
  }
  // dx0[h] = half 0's partial + half 1's
  cinbwd::fold_fields<NTW>(w, gs, red, a.x0, a.bd, a.h0, xkr, dxk, [&](int h) {
    if (t.half != 0 || q != 0) return;
    const float2 s = cinbwd::dx0_partials(red, h, t);
    if (va) a.dx0[(size_t)h * a.bd + ca] = s.x;
    if (vb) a.dx0[(size_t)h * a.bd + cb] = s.y;
  });
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int m = 8 * (j0 + j) + 2 * q;
    if (j >= ntw) break;
    if (m < a.hk) {
      if (va) a.dxk[(size_t)m * a.bd + ca] = dxk[j][0];
      if (vb) a.dxk[(size_t)m * a.bd + cb] = dxk[j][2];
    }
    if (m + 1 < a.hk) {
      if (va) a.dxk[(size_t)(m + 1) * a.bd + ca] = dxk[j][1];
      if (vb) a.dxk[(size_t)(m + 1) * a.bd + cb] = dxk[j][3];
    }
  }
}

// dw[i] = sum over splits of pdw[s][i], in split order.
__global__ void cin_interact_bwd_reduce(const float* pdw, int splits, int n_dw, float* dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_dw) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += pdw[(size_t)k * n_dw + i];
  dw[i] = s;
}

template <int NT>
cudaError_t launch_cols(const ColsArgs& a, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(cin_interact_bwd_cols<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cin_interact_bwd_cols<NT><<<(a.bd + kCols - 1) / kCols, kColsThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Column splits of K5's dW phase for a card with `sms` SMs (the wrapper
// sizes its partial-dW scratch by them).
extern "C" int cin_interact_bwd_splits(int h0, int hk, int o, int bd, int sms) {
  return cinbwd::dw_splits(h0 * hk, o, bd, sms);
}

// Launches K5 on `stream`: phases 1, 2 and 3. x0 (h0, bd) f32, xk (hk,
// bd) f32, wp (h0*hk8, o64) bf16 with hk8 = roundup8(hk), o64 =
// roundup64(o), wp[h*hk8 + m][o] = bf16(W[h*hk + m, o]) and padding 0, g
// (o, bd) f32. Scratch: sb (o + h0 + hk, roundup64(bd)) bf16, pdw (splits,
// h0*hk, o) f32 with splits from cin_interact_bwd_splits. Out: dx0 (h0,
// bd), dxk (hk, bd), dw (h0*hk, o), all f32. Returns cudaGetLastError()
// after the launches (or cudaErrorInvalidValue for a geometry outside the
// kernel's range).
extern "C" int cin_interact_bwd(const void* x0, const void* xk, const void* wp, const void* g,
                                void* sb, void* pdw, int splits, void* dx0, void* dxk,
                                void* dw, int h0, int hk, int o, int bd, void* stream) {
  if (h0 < 1 || hk < 1 || hk > 128 || o < 1 || o > 512 || bd < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ColsArgs a;
  a.x0 = static_cast<const float*>(x0);
  a.xk = static_cast<const float*>(xk);
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.g = static_cast<const float*>(g);
  a.h0 = h0;
  a.hk = hk;
  a.hk8 = round_up(hk, 8);
  a.o = o;
  a.o16 = round_up(o, 16);
  a.o64 = round_up(o, kSlice);
  a.bd = bd;
  a.bdp = round_up(bd, kSlice);
  a.gb = static_cast<__nv_bfloat16*>(sb);
  a.x0b = a.gb + (size_t)o * a.bdp;
  a.xkb = a.x0b + (size_t)h0 * a.bdp;
  a.dx0 = static_cast<float*>(dx0);
  a.dxk = static_cast<float*>(dxk);
  // the widest W slice that fits beside the staged g
  auto cols_smem = [&](int sw) {
    return a.o16 * kGStride * 2 + cinbwd::ring_bytes(a.hk8, sw) + 4 * kCols * 4;
  };
  a.sw = a.o64;
  while (a.sw > kSlice && cols_smem(a.sw) > kMaxSmem) a.sw -= kSlice;
  const int smem1 = cols_smem(a.sw);
  const int ntw = (a.hk8 / 8 + 1) / 2;
  cudaError_t err = ntw <= 2 ? launch_cols<2>(a, smem1, st)
                  : ntw <= 4 ? launch_cols<4>(a, smem1, st)
                  : ntw <= 7 ? launch_cols<7>(a, smem1, st)
                             : launch_cols<8>(a, smem1, st);
  if (err != cudaSuccess) return (int)err;

  err = cinbwd::dw_launch(a.x0b, a.xkb, a.gb, static_cast<float*>(pdw), h0, hk, o, a.bdp, splits,
                          st);
  if (err != cudaSuccess) return (int)err;
  const int k_rows = h0 * hk;
  const int n_dw = k_rows * o;
  cin_interact_bwd_reduce<<<(n_dw + 255) / 256, 256, 0, st>>>(static_cast<const float*>(pdw),
                                                              splits, n_dw, static_cast<float*>(dw));
  return (int)cudaGetLastError();
}
