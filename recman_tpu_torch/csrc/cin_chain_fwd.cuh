// K1's kernel and its launch, shared by K1's entry points
// (cin_chain_fwd.cu) and by K2's recompute form (cin_chain_bwd.cu), which
// rebuilds the fmaps with this same code, so that the rebuilt values are
// the bits K1 saves.
//
// What it computes, per layer i with fan-in Hk_i and O_i maps, on the
// field-major input x0c (H0, B*D), column n = b*D + d:
//   z[h*Hk+m, n] = bf16(bf16(x0[h, n]) * bf16(xk[m, n]))
//   pre[o, n]    = sum_{h,m} z[h*Hk+m, n] * bf16(W[h*Hk+m, o])  (f32 sums) + b[o]
//   fmap         = act(pre), act in {identity, relu, leaky_relu 0.2}
// The first O_i/2 rows of a non-final fmap are the next layer's xk; the
// other rows (all rows of the last fmap) are sum-pooled over the D
// positions of each batch row into out_i (B, F_i) f32. Two
// instantiations share every operation up to the activated fmap, so their
// fmaps are the same bits:
// - K1 (kRebuild false) writes the pooled blocks out_i and, when `fmap` is
//   given (K1's save form, the reference's CHAIN_SAVE_FMAPS), every
//   layer's whole fmap (O_i, B*D) f32, activated and not rounded;
// - the rebuild (kRebuild true, phase 0 of K2's recompute form) writes no
//   pooled block, only each non-final layer's feed rows (O_i/2, B*D) f32
//   into fmap_i and one bit per fmap element, set where fmap > 0 (which
//   gives the activation's derivative), into sign_i, laid out (O_i,
//   B*D/128, 4) uint32: word c of (row o, block j) holds, in bit `lane`,
//   column j*128 + lane*4 + c.
// The feed rows stay in shared memory for the next layer either way.
//
// Design (simple first; wgmma/TMA tiling is later work):
// - A block owns 128 columns = 128/D whole batch rows, so pooling over D
//   stays inside the block and no cross-block reduction is needed.
// - Shared memory holds the bf16-rounded x0 tile, the feed rows of the
//   current fmap (updated in place, layer by layer), and per field h one
//   chunk of z rows (Hk x 128) and of W rows (Hk x O_pad, widened to f32),
//   each filled once by the whole block and read by every warp.
// - Warp w computes maps [8w, 8w+8) for all 128 columns; each lane keeps
//   an 8 x 4 f32 accumulator tile (4 consecutive columns) and adds the
//   products in a fixed order, h outer and m inner. The products run on
//   the CUDA cores: z and W are bf16 values, so every product is exact in
//   f32 and only the order of the f32 sums differs from the plain PyTorch
//   version.
//
// Geometry taken (the callers check and refuse outside it): D divides
// 128, B*D a multiple of 128, at most 8 layers, O_i <= 256, non-final O_i
// even, H0 and Hk_i <= 128, and the shared memory of
// chain_fwd_smem_bytes <= 227 KB.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChainMaxLayers = 8;
constexpr int kChainTileN = 128;      // B*D columns per block
constexpr int kMapsPerWarp = 8;
constexpr int kChainMaxThreads = 1024;  // 32 lanes * (256 maps / 8)

struct ChainArgs {
  const float* x0c;                   // (h0, bd) f32
  int h0, bd, d, n_layers, act;
  int max_feed;                       // rows of the feed buffer
  int hk[kChainMaxLayers], o[kChainMaxLayers], o_pad[kChainMaxLayers];
  int feed[kChainMaxLayers];
  const __nv_bfloat16* w[kChainMaxLayers];  // (h0*hk, o_pad) bf16, row h*hk+m
  const float* b[kChainMaxLayers];          // (o,) f32
  float* out[kChainMaxLayers];              // (bd/d, o - feed) f32 (K1)
  float* fmap[kChainMaxLayers];             // (o, bd) f32 (K1), (feed, bd) f32 (rebuild), or null
  uint32_t* sign[kChainMaxLayers];          // (o, bd/128, 4) uint32 (rebuild)
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) return fmaxf(x, 0.0f);
  if (act == 2) return x >= 0.0f ? x : 0.2f * x;
  return x;
}

template <bool kRebuild>
__global__ void __launch_bounds__(kChainMaxThreads)
cin_chain_fwd_kernel(const ChainArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int max_hk = 0;
  for (int l = 0; l < a.n_layers; ++l) max_hk = max(max_hk, a.hk[l]);
  float* x0s = smem;                            // h0 x 128
  float* feed = x0s + a.h0 * kChainTileN;       // max_feed x 128
  float* zs = feed + a.max_feed * kChainTileN;  // max_hk x 128
  float* ws = zs + max_hk * kChainTileN;        // max over layers of hk x o_pad

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = lane * 4;                      // this lane's 4 columns
  const int col0 = blockIdx.x * kChainTileN;
  const int row0 = col0 / a.d;                  // first batch row of the block

  for (int i = tid; i < a.h0 * (kChainTileN / 4); i += nthreads) {
    const int h = i / (kChainTileN / 4), c = (i % (kChainTileN / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(
        a.x0c + (size_t)h * a.bd + col0 + c);
    *reinterpret_cast<float4*>(x0s + h * kChainTileN + c) = make_float4(
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
      for (int i = tid; i < hk * (kChainTileN / 4); i += nthreads) {
        const int m = i / (kChainTileN / 4), c = (i % (kChainTileN / 4)) * 4;
        const float4 x = *reinterpret_cast<const float4*>(x0s + h * kChainTileN + c);
        const float4 k = *reinterpret_cast<const float4*>(xk + m * kChainTileN + c);
        *reinterpret_cast<float4*>(zs + m * kChainTileN + c) = make_float4(
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
          const float4 z = *reinterpret_cast<const float4*>(zs + m * kChainTileN + n0);
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
        if constexpr (kRebuild) {
          uint4 s;
          s.x = __ballot_sync(0xffffffffu, v[0] > 0.0f);
          s.y = __ballot_sync(0xffffffffu, v[1] > 0.0f);
          s.z = __ballot_sync(0xffffffffu, v[2] > 0.0f);
          s.w = __ballot_sync(0xffffffffu, v[3] > 0.0f);
          if (lane == 0)
            reinterpret_cast<uint4*>(a.sign[l])[(size_t)om * (a.bd / kChainTileN) + blockIdx.x] = s;
        }
        if (a.fmap[l] != nullptr && (!kRebuild || om < nfeed))
          *reinterpret_cast<float4*>(a.fmap[l] + (size_t)om * a.bd + col0 + n0) =
              make_float4(v[0], v[1], v[2], v[3]);
        if (om < nfeed) {
          // only bf16(xk) enters the next layer's z
          *reinterpret_cast<float4*>(feed + om * kChainTileN + n0) = make_float4(
              bf16_round(v[0]), bf16_round(v[1]), bf16_round(v[2]), bf16_round(v[3]));
          continue;
        }
        if constexpr (kRebuild) continue;
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

// Shared memory the kernel needs for a geometry, in bytes.
int chain_fwd_smem_bytes(int h0, int n_layers, const int* units) {
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
  return ((h0 + max_feed + max_hk) * kChainTileN + max_wchunk) * (int)sizeof(float);
}

// Launches the kernel on `stream`. x0c (h0, bd) f32; w[l] (h0*hk_l,
// o_pad_l) bf16 with o_pad_l = roundup(units[l], 8) and padding columns
// zero; b[l] (units[l],) f32. K1 (sign null): out[l] (bd/d, F_l) f32, and
// fmap null or fmap[l] (units[l], bd) f32. The rebuild (sign given, out
// null): fmap[l] (units[l]/2, bd) f32 for each non-final layer (null for
// the last) and sign[l] (units[l], bd/128, 4) uint32. act: 0 identity, 1
// relu, 2 leaky_relu. Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a geometry outside the range).
int chain_fwd_launch(const void* x0c, int h0, int bd, int d, int n_layers, const int* units,
                     const void* const* w, const void* const* b, void* const* out,
                     void* const* fmap, void* const* sign, int act, cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kChainMaxLayers || h0 < 1 || h0 > 128 || d < 1 ||
      kChainTileN % d != 0 || bd % kChainTileN != 0 || act < 0 || act > 2)
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
    a.out[l] = out != nullptr ? static_cast<float*>(out[l]) : nullptr;
    a.fmap[l] = fmap != nullptr ? static_cast<float*>(fmap[l]) : nullptr;
    a.sign[l] = sign != nullptr ? static_cast<uint32_t*>(sign[l]) : nullptr;
    hk = o / 2;
  }
  const bool rebuild = sign != nullptr;
  auto kernel = rebuild ? cin_chain_fwd_kernel<true> : cin_chain_fwd_kernel<false>;
  const int smem = chain_fwd_smem_bytes(h0, n_layers, units);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * ((max_o + kMapsPerWarp - 1) / kMapsPerWarp);
  kernel<<<bd / kChainTileN, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
