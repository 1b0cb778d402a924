// K1: the whole CIN tower forward in one launch, with or without saving
// the fmaps for the backward.
//
// Replaces the TPU kernel recman_tpu/ops/cin_chain.py:_chain_fwd_kernel
// (launched from _chain_fwd_pallas). Bound to PyTorch through a plain C
// interface (ctypes); the wrapper is recman_tpu_torch/ops/cin_chain.py.
//
// What it computes, per layer i with fan-in Hk_i and O_i maps, on the
// field-major input x0c (H0, B*D), column n = b*D + d:
//   z[h*Hk+m, n] = bf16(bf16(x0[h, n]) * bf16(xk[m, n]))
//   pre[o, n]    = sum_{h,m} z[h*Hk+m, n] * bf16(W[h*Hk+m, o])  (f32 sums) + b[o]
//   fmap         = act(pre), act in {identity, relu, leaky_relu 0.2}
// The first O_i/2 rows of a non-final fmap are the next layer's xk; the
// other rows (all rows of the last fmap) are sum-pooled over the D
// positions of each batch row into out_i (B, F_i) f32. Without `fmap`
// (serving) only the pooled outputs are written and the fmaps never
// leave the block. With it (the reference's CHAIN_SAVE_FMAPS, training)
// every layer's whole fmap, activated and not rounded, is also written
// to fmap_i (O_i, B*D) f32 for the backward (K2, csrc/cin_chain_bwd.cu);
// the feed rows still stay in shared memory for the next layer.
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
//
// Design (simple first; wgmma/TMA tiling is later work):
// - A block owns 128 columns = 128/D whole batch rows, so pooling over D
//   stays inside the block and no cross-block reduction is needed.
// - Shared memory holds the bf16-rounded x0 tile, the feed rows of the
//   current fmap (updated in place, layer by layer), and per field h one
//   chunk of z rows (Hk x 128) and of W rows (Hk x O_pad, widened to f32),
//   each filled once by the whole block and read by every warp.
// - Warp w computes maps [8w, 8w+8) for all 128 columns; each lane keeps
//   an 8 x 4 f32 accumulator tile (4 consecutive columns). The products
//   run on the CUDA cores: z and W are bf16 values, so every product is
//   exact in f32 and only the order of the f32 sums differs from the
//   plain PyTorch version.
//
// Geometry taken (the wrapper checks and raises outside it): D divides
// 128, B*D a multiple of 128, at most 8 layers, O_i <= 256, non-final O_i
// even, H0 and Hk_i <= 128, and the shared memory below <= 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kTileN = 128;           // B*D columns per block
constexpr int kMapsPerWarp = 8;
constexpr int kMaxThreads = 1024;     // 32 lanes * (256 maps / 8)

struct ChainArgs {
  const float* x0c;                   // (h0, bd) f32
  int h0, bd, d, n_layers, act;
  int max_feed;                       // rows of the feed buffer
  int hk[kMaxLayers], o[kMaxLayers], o_pad[kMaxLayers], feed[kMaxLayers];
  const __nv_bfloat16* w[kMaxLayers]; // (h0*hk, o_pad) bf16, row h*hk+m
  const float* b[kMaxLayers];         // (o,) f32
  float* out[kMaxLayers];             // (bd/d, o - feed) f32
  float* fmap[kMaxLayers];            // (o, bd) f32, or null: not saved
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) return fmaxf(x, 0.0f);
  if (act == 2) return x >= 0.0f ? x : 0.2f * x;
  return x;
}

__global__ void __launch_bounds__(kMaxThreads)
cin_chain_fwd_kernel(const ChainArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int max_hk = 0;
  for (int l = 0; l < a.n_layers; ++l) max_hk = max(max_hk, a.hk[l]);
  float* x0s = smem;                            // h0 x 128
  float* feed = x0s + a.h0 * kTileN;            // max_feed x 128
  float* zs = feed + a.max_feed * kTileN;       // max_hk x 128
  float* ws = zs + max_hk * kTileN;             // max over layers of hk x o_pad

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = lane * 4;                      // this lane's 4 columns
  const int col0 = blockIdx.x * kTileN;
  const int row0 = col0 / a.d;                  // first batch row of the block

  for (int i = tid; i < a.h0 * (kTileN / 4); i += nthreads) {
    const int h = i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(
        a.x0c + (size_t)h * a.bd + col0 + c);
    *reinterpret_cast<float4*>(x0s + h * kTileN + c) = make_float4(
        bf16_round(v.x), bf16_round(v.y), bf16_round(v.z), bf16_round(v.w));
  }

  const float* xk = x0s;
  for (int l = 0; l < a.n_layers; ++l) {
    const int hk = a.hk[l], o = a.o[l], o_pad = a.o_pad[l], nfeed = a.feed[l];
    const int m0 = warp * kMapsPerWarp;         // first map of this warp
    const bool active = m0 < o;                 // warp-uniform
    float acc[kMapsPerWarp][4];
#pragma unroll
    for (int j = 0; j < kMapsPerWarp; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

    for (int h = 0; h < a.h0; ++h) {
      __syncthreads();  // the previous chunk is consumed (and x0s / feed written)
      for (int i = tid; i < hk * (kTileN / 4); i += nthreads) {
        const int m = i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
        const float4 x = *reinterpret_cast<const float4*>(x0s + h * kTileN + c);
        const float4 k = *reinterpret_cast<const float4*>(xk + m * kTileN + c);
        *reinterpret_cast<float4*>(zs + m * kTileN + c) = make_float4(
            bf16_round(x.x * k.x), bf16_round(x.y * k.y),
            bf16_round(x.z * k.z), bf16_round(x.w * k.w));
      }
      const uint4* wsrc =
          reinterpret_cast<const uint4*>(a.w[l] + (size_t)h * hk * o_pad);
      for (int i = tid; i < hk * o_pad / 8; i += nthreads) {
        const uint4 u = __ldg(wsrc + i);
        float4* dst = reinterpret_cast<float4*>(ws + i * 8);
        dst[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                             __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        dst[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                             __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      }
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int m = 0; m < hk; ++m) {
          const float4 z = *reinterpret_cast<const float4*>(zs + m * kTileN + n0);
          const float4 wa = *reinterpret_cast<const float4*>(ws + m * o_pad + m0);
          const float4 wb = *reinterpret_cast<const float4*>(ws + m * o_pad + m0 + 4);
          const float wv[kMapsPerWarp] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < kMapsPerWarp; ++j) {
            acc[j][0] = fmaf(wv[j], z.x, acc[j][0]);
            acc[j][1] = fmaf(wv[j], z.y, acc[j][1]);
            acc[j][2] = fmaf(wv[j], z.z, acc[j][2]);
            acc[j][3] = fmaf(wv[j], z.w, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done reading xk: the feed rows may be overwritten

    if (active) {
      const int nout = o - nfeed;
#pragma unroll
      for (int j = 0; j < kMapsPerWarp; ++j) {
        const int om = m0 + j;
        if (om >= o) break;                     // warp-uniform
        const float bias = a.b[l][om];
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = activate(acc[j][c] + bias, a.act);
        if (a.fmap[l] != nullptr)
          *reinterpret_cast<float4*>(a.fmap[l] + (size_t)om * a.bd + col0 + n0) =
              make_float4(v[0], v[1], v[2], v[3]);
        if (om < nfeed) {
          // only bf16(xk) enters the next layer's z
          *reinterpret_cast<float4*>(feed + om * kTileN + n0) = make_float4(
              bf16_round(v[0]), bf16_round(v[1]), bf16_round(v[2]), bf16_round(v[3]));
          continue;
        }
        float* dst = a.out[l] + (om - nfeed);
        if (a.d >= 4) {
          float s = (v[0] + v[1]) + (v[2] + v[3]);
          const int q = a.d / 4;                // lanes per batch row
          for (int off = 1; off < q; off <<= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if ((lane & (q - 1)) == 0)
            dst[(size_t)(row0 + n0 / a.d) * nout] = s;
        } else {
          for (int c = 0; c < 4; c += a.d) {
            float s = 0.0f;
            for (int e = 0; e < a.d; ++e) s += v[c + e];
            dst[(size_t)(row0 + (n0 + c) / a.d) * nout] = s;
          }
        }
      }
    }
    xk = feed;
  }
}

}  // namespace

// Shared memory the kernel needs for a geometry, in bytes.
extern "C" int cin_chain_fwd_smem_bytes(int h0, int n_layers, const int* units) {
  int hk = h0, max_hk = 0, max_feed = 0, max_wchunk = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int o = units[l];
    const bool final_layer = l == n_layers - 1;
    if (hk > max_hk) max_hk = hk;
    if (!final_layer && o / 2 > max_feed) max_feed = o / 2;
    const int wchunk = hk * ((o + 7) / 8 * 8);
    if (wchunk > max_wchunk) max_wchunk = wchunk;
    hk = o / 2;
  }
  return ((h0 + max_feed + max_hk) * kTileN + max_wchunk) * (int)sizeof(float);
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
  if (n_layers < 1 || n_layers > kMaxLayers || h0 < 1 || h0 > 128 || d < 1 ||
      kTileN % d != 0 || bd % kTileN != 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.x0c = static_cast<const float*>(x0c);
  a.h0 = h0;
  a.bd = bd;
  a.d = d;
  a.n_layers = n_layers;
  a.act = act;
  a.max_feed = 0;
  int hk = h0, max_o = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int o = units[l];
    const bool final_layer = l == n_layers - 1;
    if (o < 1 || o > 256 || (!final_layer && o % 2 != 0) || hk > 128)
      return (int)cudaErrorInvalidValue;
    a.hk[l] = hk;
    a.o[l] = o;
    a.o_pad[l] = (o + 7) / 8 * 8;
    a.feed[l] = final_layer ? 0 : o / 2;
    if (a.feed[l] > a.max_feed) a.max_feed = a.feed[l];
    if (o > max_o) max_o = o;
    a.w[l] = static_cast<const __nv_bfloat16*>(w[l]);
    a.b[l] = static_cast<const float*>(b[l]);
    a.out[l] = static_cast<float*>(out[l]);
    a.fmap[l] = fmap != nullptr ? static_cast<float*>(fmap[l]) : nullptr;
    hk = o / 2;
  }
  const int smem = cin_chain_fwd_smem_bytes(h0, n_layers, units);
  cudaError_t err = cudaFuncSetAttribute(
      cin_chain_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * ((max_o + kMapsPerWarp - 1) / kMapsPerWarp);
  cin_chain_fwd_kernel<<<bd / kTileN, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
