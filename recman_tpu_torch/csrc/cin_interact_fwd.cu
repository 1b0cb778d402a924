// K4: one CIN layer's interaction forward, field-major.
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
// MB) take 16 us at 3.35 TB/s.
//
// Design (simple first, like K1's layer loop without its pooling, so D is
// free; tensor cores are later work):
// - A block owns 128 columns and a tile of up to 256 maps (blockIdx.y);
//   warp w computes maps [8w, 8w+8) of the tile for all 128 columns, each
//   lane an 8 x 4 f32 accumulator (4 consecutive columns).
// - The contraction walks the X = H0*Hk rows of z and W in chunks of 32:
//   the block builds the chunk's z rows (32 x 128, from x0 and xk in
//   device memory, L1-resident across chunks) and widens the chunk's W
//   rows (32 x the tile's maps) to f32 in shared memory; every warp reads
//   both. The products run on the CUDA cores: z and W are bf16 values, so
//   every product is exact in f32 and only the order of the f32 sums
//   differs from the plain PyTorch version.
// - Columns past B*D (the tail tile) build z = 0 and are not stored.
//
// Geometry taken (the wrapper checks and raises outside it): any H0 >= 1
// and B*D >= 1, 1 <= Hk <= 128, 1 <= O <= 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 128;        // B*D columns per block
constexpr int kMapsPerWarp = 8;
constexpr int kMaxTileO = 256;     // maps per block
constexpr int kChunk = 32;         // rows of z and W per step

struct FwdArgs {
  const float* x0;                 // (h0, bd) f32
  const float* xk;                 // (hk, bd) f32
  const __nv_bfloat16* w;          // (h0*hk, o_pad) bf16, row h*hk+m
  float* out;                      // (o, bd) f32
  int h0, hk, o, o_pad, bd, tile_o;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(1024) cin_interact_fwd_kernel(const FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);  // kChunk x 128
  float* ws = zs + kChunk * kTileN;             // kChunk x tile_o

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = lane * 4;
  const int col0 = blockIdx.x * kTileN;
  const int o_base = blockIdx.y * a.tile_o;
  const int m0 = warp * kMapsPerWarp;         // first map of this warp in the tile
  const bool active = o_base + m0 < a.o;      // warp-uniform
  const int x_rows = a.h0 * a.hk;

  float acc[kMapsPerWarp][4];
#pragma unroll
  for (int j = 0; j < kMapsPerWarp; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int xc = 0; xc < x_rows; xc += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kChunk * kTileN; i += nthreads) {
      const int x = xc + (i >> 7), col = col0 + (i & (kTileN - 1));
      float v = 0.0f;
      if (x < x_rows && col < a.bd) {
        const int h = x / a.hk, m = x - h * a.hk;
        v = bf16_round(bf16_round(a.x0[(size_t)h * a.bd + col]) *
                       bf16_round(a.xk[(size_t)m * a.bd + col]));
      }
      zs[i] = v;
    }
    const int q = a.tile_o / 8;  // 16-byte pieces of a W row in the tile
    for (int i = tid; i < kChunk * q; i += nthreads) {
      const int r = i / q, c = (i - r * q) * 8;
      const int x = xc + r;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (x < x_rows && o_base + c < a.o_pad) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(a.w + (size_t)x * a.o_pad + o_base + c));
        lo = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        hi = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                         __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      }
      float4* dst = reinterpret_cast<float4*>(ws + r * a.tile_o + c);
      dst[0] = lo;
      dst[1] = hi;
    }
    __syncthreads();
    if (active) {
      const int rows = min(kChunk, x_rows - xc);
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const float4 z = *reinterpret_cast<const float4*>(zs + r * kTileN + n0);
        const float4 wa = *reinterpret_cast<const float4*>(ws + r * a.tile_o + m0);
        const float4 wb = *reinterpret_cast<const float4*>(ws + r * a.tile_o + m0 + 4);
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

  if (!active) return;
  const int col = col0 + n0;
  const bool vec = (a.bd & 3) == 0 && col + 3 < a.bd;
#pragma unroll
  for (int j = 0; j < kMapsPerWarp; ++j) {
    const int o = o_base + m0 + j;
    if (o >= a.o) break;  // warp-uniform
    float* dst = a.out + (size_t)o * a.bd + col;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < a.bd) dst[c] = acc[j][c];
    }
  }
}

}  // namespace

// Launches K4 on `stream`. x0 (h0, bd) f32, xk (hk, bd) f32, w (h0*hk,
// o_pad) bf16 with o_pad = roundup(o, 8) and padding columns zero, out
// (o, bd) f32. Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a geometry outside the kernel's range).
extern "C" int cin_interact_fwd(const void* x0, const void* xk, const void* w, void* out,
                                int h0, int hk, int o, int bd, void* stream) {
  if (h0 < 1 || hk < 1 || hk > 128 || o < 1 || o > 512 || bd < 1)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.x0 = static_cast<const float*>(x0);
  a.xk = static_cast<const float*>(xk);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.out = static_cast<float*>(out);
  a.h0 = h0;
  a.hk = hk;
  a.o = o;
  a.o_pad = (o + 7) / 8 * 8;
  a.bd = bd;
  a.tile_o = a.o_pad < kMaxTileO ? a.o_pad : kMaxTileO;
  const int smem = (kChunk * kTileN + kChunk * a.tile_o) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cin_interact_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((bd + kTileN - 1) / kTileN, (o + a.tile_o - 1) / a.tile_o);
  const int threads = 32 * (a.tile_o / kMapsPerWarp);
  cin_interact_fwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
