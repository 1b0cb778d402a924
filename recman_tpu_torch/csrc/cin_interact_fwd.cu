// K4: one CIN layer's interaction forward, field-major, on the tensor cores.
//
// Replaces the TPU kernel recman_tpu/ops/cin_interact.py:_fwd_kernel
// (launched from _pallas_fwd). Bound to PyTorch through a plain C
// interface (ctypes); the wrapper is recman_tpu_torch/ops/cin_interact.py.
//
// What it computes, on x0c (H0, B*D), xkc (Hk, B*D) and W (H0*Hk, O),
// column n = b*D + d:
//   z[h*Hk+m, n] = bf16(bf16(x0[h, n]) * bf16(xk[m, n]))
//   pre[o, n]    = sum_x bf16(W[x, o]) * z[x, n]   (f32 sums)
// No bias, no activation, no pooling: the layer adds those in PyTorch.
// The product of two bf16 values is exact in f32, so z rounds once, as in
// the reference.
//
// Bound on an H100 SXM: operations. At the xDeepFM paper's Criteo layer
// (H0 = 26, Hk = 100, O = 200, B*D = 40,960) the contraction is 42.6
// GFLOP of bf16 products, 43 us at the 989 TFLOP/s bf16 tensor-core peak;
// the bytes (x0c and xkc in, 4.3 + 16.4 MB, the (O, B*D) f32 output 32.8
// MB) take 16 us at 3.35 TB/s. So the products go to the tensor cores:
// mma.sync.m16n8k16 with bf16 operands and f32 sums (tensor_core.cuh).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chain_readings.py
// timing): 0.488-0.497 ms at that layer (87 TFLOP/s) with its sums split
// per ring slice (cin_fwd_mma.cuh), 0.331-0.336 with one accumulation
// (128 TFLOP/s). What holds it above the bound is latency, not
// the tensor pipe: each k-step's B fragments wait on their shared-memory
// loads and multiply, its A fragments on ldmatrix, and the two map tiles
// of O 200 build the same z twice. wgmma is the next step.
//
// Design: one product pre (O x B*D) = bf16(W)^T (O x X) . z (X x B*D).
// The k-loop is shared with K1 (cin_fwd_mma.cuh).
// - The wrapper lays bf16(W) out as Wt (O, Kp): Wt[o][h*Hk8 + m] =
//   bf16(W[h*Hk+m, o]), Hk8 = Hk rounded up to 8, zero padding, Kp a
//   multiple of 64. With Hk8 a multiple of 8, every 8 consecutive rows of
//   the padded z belong to one field h, so the loop knows (h, m) from two
//   counters and never divides.
// - A block owns 128 maps x 128 columns; 8 warps as 2 (maps) x 4
//   (columns), each warp 64 maps x 32 columns: 4 x 4 m16n8 tiles, 64 f32
//   accumulators a thread.
// - The A operand, Wt's k-slices of 64 (128 maps x 64, bf16), streams
//   through a ring of 3 stages with cp.async, two slices in flight while
//   one multiplies; ldmatrix reads the fragments. Rows past O read zeros
//   (cp.async zero-fill). Wt is 1.1 MB, so it stays in L2 for all blocks.
// - The B operand z is never stored. At the block's start xk and x0 of
//   its columns are staged once in shared memory as bf16, transposed
//   (column-major, m contiguous); each thread then builds its B fragment
//   straight into registers: one 32-bit load of (xk[m], xk[m+1]), one of
//   x0[h], and one bf16x2 multiply. Padding m past Hk reads zero.
// - The epilogue stages each half of the output tile (64 maps x 128
//   columns, f32) in the ring's shared memory and stores (O, B*D) rows
//   coalesced, 16 bytes a thread. Maps past O and columns past B*D (the
//   tail tile) are not stored.
// - Each output element is owned by one thread of one block and summed in
//   a fixed order: no atomics, and two calls are bit-equal. Fields beyond
//   64 (shared memory holds x0 for 64 fields) run as further launches on
//   the same stream that add to the output in field order.
//
// Geometry taken (the wrapper checks and raises outside it): any H0 >= 1
// and B*D >= 1, 1 <= Hk <= 128, 1 <= O <= 512.

#include "cin_fwd_mma.cuh"

namespace {

using cinfwd::kBK;
using cinfwd::kStages;
using cinfwd::kWStride;
using cinfwd::round_up;

constexpr int kThreads = 256;
constexpr int kBM = 128;            // maps per block
constexpr int kBN = 128;            // B*D columns per block
constexpr int kOutStride = kBN + 8; // f32 per staged output row
constexpr int kH0Chunk = 64;        // fields per launch
constexpr int kSplit = 4;           // k16 steps per fresh fragment (cin_fwd_mma.cuh);
                                    // tools/chain_readings.py builds the others

struct FwdArgs {
  const float* x0;             // (h0c, bd) f32: this launch's fields
  const float* xk;             // (hk, bd) f32
  const __nv_bfloat16* wt;     // (o, kp) bf16, at this launch's first field's column
  float* out;                  // (o, bd) f32
  int h0c, hk, hk8, o, bd, kp;
  int xs, x0st;                // bf16 per staged column of xk and of x0
  int accumulate;              // add to out (the fields of an earlier launch)
};

__global__ void __launch_bounds__(kThreads, 2) cin_interact_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // kStages x kBM x kWStride
  __nv_bfloat16* xks = ring + kStages * kBM * kWStride;           // kBN x xs: [n][m]
  __nv_bfloat16* x0s = xks + kBN * a.xs;                          // kBN x x0st: [n][h]
  float* outs = reinterpret_cast<float*>(smem);                   // 64 x kOutStride, after the loop

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int col0 = blockIdx.x * kBN;
  const int o_base = blockIdx.y * kBM;
  const int kz = a.h0c * a.hk8;  // padded z rows of this launch
  const int nchunks = (kz + kBK - 1) / kBK;

  auto load_w = [&](int c) {
    cinfwd::load_w_slice(ring + (c % kStages) * kBM * kWStride, a.wt + (size_t)o_base * a.kp,
                         a.kp, c, kBM, a.o - o_base, tid, kThreads);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_w(s);
    tc::cp_async_commit();
  }

  // xk (rows [0, hk8)) and x0 (rows [hk8, hk8 + h0c)) of the block's
  // columns, bf16, column-major; zero past Hk and B*D. Each thread keeps 4
  // loads of 16 bytes in flight before it stores.
  const int quads = (a.hk8 + a.h0c) * (kBN / 4);
  for (int i0 = tid; i0 < quads; i0 += 4 * kThreads) {
    float4 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + e * kThreads, r = i >> 5, col = col0 + (i & 31) * 4;
      v[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < quads && r < a.hk) v[e] = tc::load4(a.xk + (size_t)r * a.bd, col, a.bd);
      else if (i < quads && r >= a.hk8) v[e] = tc::load4(a.x0 + (size_t)(r - a.hk8) * a.bd, col, a.bd);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + e * kThreads, r = i >> 5, n = (i & 31) * 4;
      if (i >= quads) break;
      __nv_bfloat16* dst = r < a.hk8 ? xks + n * a.xs + r : x0s + n * a.x0st + (r - a.hk8);
      const int st = r < a.hk8 ? a.xs : a.x0st;
      dst[0] = __float2bfloat16_rn(v[e].x);
      dst[st] = __float2bfloat16_rn(v[e].y);
      dst[2 * st] = __float2bfloat16_rn(v[e].z);
      dst[3 * st] = __float2bfloat16_rn(v[e].w);
    }
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  // m16 tiles of this warp that hold a map below O (warp-uniform)
  int mt = (a.o - o_base - wm * 64 + 15) / 16;
  mt = mt < 0 ? 0 : (mt > 4 ? 4 : mt);
  // this thread's B columns n = wn*32 + 8j + g, as offsets into xks and x0s
  cinfwd::z_product<kSplit>(acc, ring, kBM * kWStride, load_w, xks + (wn * 32 + g) * a.xs + 2 * q, a.xs,
                    x0s + (wn * 32 + g) * a.x0st, a.x0st, a.h0c, a.hk8, kz, mt, wm * 64);
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the output

  const bool vec = (a.bd & 3) == 0;
  for (int half = 0; half < 2; ++half) {
    if (wm == half) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* p = outs + (i * 16 + g) * kOutStride + wn * 32 + j * 8 + 2 * q;
          *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<float2*>(p + 8 * kOutStride) = make_float2(acc[i][j][2], acc[i][j][3]);
        }
    }
    __syncthreads();
    for (int i = tid; i < 64 * (kBN / 4); i += kThreads) {
      const int r = i >> 5, c4 = (i & 31) * 4;
      const int o = o_base + half * 64 + r, col = col0 + c4;
      if (o >= a.o || col >= a.bd) continue;
      float4 v = *reinterpret_cast<const float4*>(outs + r * kOutStride + c4);
      float* dst = a.out + (size_t)o * a.bd + col;
      if (vec) {
        if (a.accumulate) {
          const float4 p = *reinterpret_cast<const float4*>(dst);
          v = make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
        }
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (col + k < a.bd) dst[k] = a.accumulate ? dst[k] + e[k] : e[k];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches K4 on `stream`. x0 (h0, bd) f32, xk (hk, bd) f32, wt (o, kp)
// bf16 with kp = roundup64(h0 * hk8) and wt[o][h*hk8 + m] =
// bf16(W[h*hk + m, o]), hk8 = roundup8(hk), padding zero; out (o, bd)
// f32. Returns cudaGetLastError() after the launches (or
// cudaErrorInvalidValue for a geometry outside the kernel's range).
extern "C" int cin_interact_fwd(const void* x0, const void* xk, const void* wt, void* out,
                                int h0, int hk, int o, int bd, void* stream) {
  if (h0 < 1 || hk < 1 || hk > 128 || o < 1 || o > 512 || bd < 1)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.xk = static_cast<const float*>(xk);
  a.out = static_cast<float*>(out);
  a.hk = hk;
  a.hk8 = round_up(hk, 8);
  a.o = o;
  a.bd = bd;
  a.kp = round_up(h0 * a.hk8, kBK);
  a.xs = cinfwd::xk_stride(a.hk8);
  const dim3 grid((bd + kBN - 1) / kBN, (o + kBM - 1) / kBM);
  for (int hb = 0; hb < h0; hb += kH0Chunk) {
    a.h0c = h0 - hb < kH0Chunk ? h0 - hb : kH0Chunk;
    a.x0st = cinfwd::x0_stride(a.h0c);
    a.x0 = static_cast<const float*>(x0) + (size_t)hb * bd;
    a.wt = static_cast<const __nv_bfloat16*>(wt) + (size_t)hb * a.hk8;
    a.accumulate = hb > 0;
    const int smem = (kStages * kBM * kWStride + kBN * (a.xs + a.x0st)) * 2;
    cudaError_t err = cudaFuncSetAttribute(
        cin_interact_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cin_interact_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
