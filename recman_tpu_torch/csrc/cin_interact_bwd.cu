// K5: one CIN layer's interaction backward, field-major.
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
// dxk out, 41.0 MB, W and dW 4.2 MB) take 23 us at 3.35 TB/s.
//
// Design (simple and deterministic first; tensor cores are later work),
// K2's phases with one layer:
// - The TPU kernel carries dW in VMEM across its sequential grid. Blocks
//   on the card run in no order, so the work splits into phases with no
//   atomics, each sum in a fixed order, and two calls are bit-equal:
//   1. cin_interact_bwd_cols: everything except dW is local to a column.
//      A block owns 128 columns: it stages bf16(g) (O x 128) and xk
//      (Hk x 128) in shared memory and writes bf16(g) transposed, (B*D,
//      O_pad), for phase 2. u for the whole layer is X x 128 f32, too big
//      for shared memory, so it is formed one field h at a time (Hk rows,
//      W walked in chunks of maps sized to fit) and folded at once into
//      dx0[h] (an in-order sum over the warps) and the dxk registers.
//      Warp w owns rows [8w, 8w+8) of u and of dxk, each lane 4
//      consecutive columns.
//   2. cin_interact_bwd_dw: dW = z . gb^T over all B*D columns. A block
//      owns 128 rows and 128 maps of dW and one split of the columns; it
//      rebuilds its z rows from x0 and xk, 64 columns at a time, and
//      writes a partial dW per split.
//   3. cin_interact_bwd_reduce: dW = the sum of the split partials, in
//      split order.
// - The products run on the CUDA cores in f32. Every product is of two
//   bf16 values, or an f32 product the reference also forms in f32, so
//   only the order of the f32 sums differs from the plain version.
// - Columns past B*D (the tail tile) read 0 and are not stored.
//
// Geometry taken (the wrapper checks and raises outside it): any H0 >= 1
// and B*D >= 1, 1 <= Hk <= 128, 1 <= O <= 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 128;   // B*D columns per block of phase 1
constexpr int kRows = 8;      // rows of u per warp
constexpr int kMinWarps = 4;
constexpr int kGStride = 132; // bf16 per gb row in shared memory
constexpr int kTileR = 128;   // dW rows per block of phase 2
constexpr int kChunk = 64;    // columns per step of phase 2
constexpr int kStage = kChunk + 1;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

struct ColsArgs {
  const float* x0;             // (h0, bd) f32
  const float* xk;             // (hk, bd) f32
  const __nv_bfloat16* wt;     // (h0, o, hk_pad) bf16: [h][o][m] = W[h*hk+m, o]
  const float* g;              // (o, bd) f32
  __nv_bfloat16* gt;           // (bd, o_pad) bf16: bf16(g) transposed
  float* dx0;                  // (h0, bd) f32
  float* dxk;                  // (hk, bd) f32
  int h0, hk, hk_pad, o, o_pad, bd, nwarps, o_chunk;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 4 consecutive f32 of a row from column col, 0 past bd.
__device__ __forceinline__ float4 load4(const float* row, int col, int bd) {
  if ((bd & 3) == 0 && col + 3 < bd) return *reinterpret_cast<const float4*>(row + col);
  return make_float4(col < bd ? row[col] : 0.f, col + 1 < bd ? row[col + 1] : 0.f,
                     col + 2 < bd ? row[col + 2] : 0.f, col + 3 < bd ? row[col + 3] : 0.f);
}

__device__ __forceinline__ void store4(float* row, int col, int bd, float4 v) {
  if ((bd & 3) == 0 && col + 3 < bd) {
    *reinterpret_cast<float4*>(row + col) = v;
    return;
  }
  if (col < bd) row[col] = v.x;
  if (col + 1 < bd) row[col + 1] = v.y;
  if (col + 2 < bd) row[col + 2] = v.z;
  if (col + 3 < bd) row[col + 3] = v.w;
}

__global__ void __launch_bounds__(512) cin_interact_bwd_cols(const ColsArgs a) {
  extern __shared__ float4 smem4[];
  float* xks = reinterpret_cast<float*>(smem4);  // hk x 128, f32
  float* red = xks + a.hk * kTileN;              // nwarps x 128: partial dx0 sums
  __nv_bfloat16* wts =                           // o_chunk x hk_pad: a chunk of one field's W
      reinterpret_cast<__nv_bfloat16*>(red + a.nwarps * kTileN);
  __nv_bfloat16* gps = wts + a.o_chunk * a.hk_pad;  // o x kGStride: bf16(g)

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = lane * 4;
  const int col0 = blockIdx.x * kTileN;

  for (int i = tid; i < a.o * kTileN; i += nthreads) {
    const int r = i >> 7, n = i & (kTileN - 1), col = col0 + n;
    gps[r * kGStride + n] = __float2bfloat16_rn(col < a.bd ? a.g[(size_t)r * a.bd + col] : 0.0f);
  }
  for (int i = tid; i < a.hk * kTileN; i += nthreads) {
    const int m = i >> 7, n = i & (kTileN - 1), col = col0 + n;
    xks[i] = col < a.bd ? a.xk[(size_t)m * a.bd + col] : 0.0f;
  }
  __syncthreads();

  // bf16(g) transposed to (bd, o_pad) for the dW phase, padding maps 0
  for (int i = tid; i < kTileN * (a.o_pad / 2); i += nthreads) {
    const int n = i / (a.o_pad / 2), r = (i % (a.o_pad / 2)) * 2;
    if (col0 + n >= a.bd) continue;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    __nv_bfloat162 v;
    v.x = r < a.o ? gps[r * kGStride + n] : zero;
    v.y = r + 1 < a.o ? gps[(r + 1) * kGStride + n] : zero;
    *reinterpret_cast<__nv_bfloat162*>(a.gt + (size_t)(col0 + n) * a.o_pad + r) = v;
  }

  const int m0 = warp * kRows;
  const bool active = m0 < a.hk;                // warp-uniform
  const int nact = (a.hk + kRows - 1) / kRows;  // warps that own rows
  float dxk[kRows][4];
#pragma unroll
  for (int j = 0; j < kRows; ++j) dxk[j][0] = dxk[j][1] = dxk[j][2] = dxk[j][3] = 0.0f;

  for (int h = 0; h < a.h0; ++h) {
    float acc[kRows][4];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    for (int oc0 = 0; oc0 < a.o; oc0 += a.o_chunk) {
      const int oc = min(a.o_chunk, a.o - oc0);
      __syncthreads();  // the previous W chunk and the partial sums are consumed
      const uint4* wsrc =
          reinterpret_cast<const uint4*>(a.wt + ((size_t)h * a.o + oc0) * a.hk_pad);
      uint4* wdst = reinterpret_cast<uint4*>(wts);
      for (int i = tid; i < oc * a.hk_pad / 8; i += nthreads) wdst[i] = __ldg(wsrc + i);
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int r = 0; r < oc; ++r) {
          const uint2 gu = *reinterpret_cast<const uint2*>(gps + (oc0 + r) * kGStride + n0);
          const float gv[4] = {__uint_as_float(gu.x << 16), __uint_as_float(gu.x & 0xffff0000u),
                               __uint_as_float(gu.y << 16), __uint_as_float(gu.y & 0xffff0000u)};
          const uint4 wu = *reinterpret_cast<const uint4*>(wts + r * a.hk_pad + m0);
          const float wv[kRows] = {
              __uint_as_float(wu.x << 16), __uint_as_float(wu.x & 0xffff0000u),
              __uint_as_float(wu.y << 16), __uint_as_float(wu.y & 0xffff0000u),
              __uint_as_float(wu.z << 16), __uint_as_float(wu.z & 0xffff0000u),
              __uint_as_float(wu.w << 16), __uint_as_float(wu.w & 0xffff0000u)};
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][c] = fmaf(wv[j], gv[c], acc[j][c]);
          }
        }
      }
    }
    if (active) {
      // fold u's rows for field h into dxk (times x0[h]) and dx0[h] (times xk)
      const float4 xv = load4(a.x0 + (size_t)h * a.bd, col0 + n0, a.bd);
      const float x0v[4] = {xv.x, xv.y, xv.z, xv.w};
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int m = m0 + j;
        if (m < a.hk) {
          const float4 kv = *reinterpret_cast<const float4*>(xks + m * kTileN + n0);
          const float xkv[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dxk[j][c] = fmaf(acc[j][c], x0v[c], dxk[j][c]);
            part[c] = fmaf(acc[j][c], xkv[c], part[c]);
          }
        }
      }
      *reinterpret_cast<float4*>(red + warp * kTileN + n0) =
          make_float4(part[0], part[1], part[2], part[3]);
    }
    __syncthreads();
    for (int i = tid; i < kTileN; i += nthreads) {
      float s = 0.0f;
      for (int w = 0; w < nact; ++w) s += red[w * kTileN + i];
      if (col0 + i < a.bd) a.dx0[(size_t)h * a.bd + col0 + i] = s;
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int m = m0 + j;
    if (m >= a.hk) break;
    store4(a.dxk + (size_t)m * a.bd, col0 + n0, a.bd,
           make_float4(dxk[j][0], dxk[j][1], dxk[j][2], dxk[j][3]));
  }
}

struct DwArgs {
  const float* x0;              // (h0, bd) f32
  const float* xk;              // (hk, bd) f32
  const __nv_bfloat16* gt;      // (bd, o_pad) bf16
  float* pdw;                   // (splits, h0*hk, o) f32
  int h0, hk, o, o_pad, bd, splits;
};

__global__ void __launch_bounds__(256) cin_interact_bwd_dw(const DwArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* zs = smem;                       // kChunk x kTileR: z[n][r]
  float* gs = zs + kChunk * kTileR;       // kChunk x 128:    gb[n][o_base + o]
  float* stage = gs + kChunk * kTileR;    // (nh + hk) x kStage: bf16(x0), bf16(xk)

  const int tid = threadIdx.x;
  const int k_rows = a.h0 * a.hk;
  const int r_base = blockIdx.x * kTileR;
  const int o_base = blockIdx.z * 128;
  const int h_lo = r_base / a.hk;
  const int h_hi = min(a.h0 - 1, (r_base + kTileR - 1) / a.hk);
  const int nh = h_hi - h_lo + 1;
  const int nchunks = (a.bd + kChunk - 1) / kChunk;
  const int c_begin = (int)((long long)nchunks * blockIdx.y / a.splits);
  const int c_end = (int)((long long)nchunks * (blockIdx.y + 1) / a.splits);

  // this thread's z row, fixed for the whole block
  const int zr = tid & (kTileR - 1);
  const int rr = r_base + zr;
  const bool zvalid = rr < k_rows;
  const int zh = zvalid ? rr / a.hk - h_lo : 0;
  const int zm = zvalid ? rr % a.hk : 0;

  // this thread's 8 x 8 outputs: rows {4rg..4rg+3, 64+4rg..}, maps {4og.., 64+4og..}
  const int rg = tid >> 4, og = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int c0 = ch * kChunk;
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int i = tid; i < (nh + a.hk) * kChunk; i += blockDim.x) {
      const int row = i / kChunk, n = i % kChunk, col = c0 + n;
      float v = 0.0f;
      if (col < a.bd)
        v = row < nh ? a.x0[(size_t)(h_lo + row) * a.bd + col]
                     : a.xk[(size_t)(row - nh) * a.bd + col];
      stage[row * kStage + n] = bf16_round(v);
    }
    for (int i = tid; i < kChunk * 16; i += blockDim.x) {
      const int n = i / 16, q = (i % 16) * 8;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (c0 + n < a.bd && o_base + q < a.o_pad) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            a.gt + (size_t)(c0 + n) * a.o_pad + o_base + q));
        lo = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        hi = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                         __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      }
      *reinterpret_cast<float4*>(gs + n * kTileR + q) = lo;
      *reinterpret_cast<float4*>(gs + n * kTileR + q + 4) = hi;
    }
    __syncthreads();
    for (int n = tid >> 7; n < kChunk; n += 2)
      zs[n * kTileR + zr] = zvalid
          ? bf16_round(stage[zh * kStage + n] * stage[(nh + zm) * kStage + n])
          : 0.0f;
    __syncthreads();
#pragma unroll 2
    for (int n = 0; n < kChunk; ++n) {
      const float4 za = *reinterpret_cast<const float4*>(zs + n * kTileR + rg * 4);
      const float4 zb = *reinterpret_cast<const float4*>(zs + n * kTileR + 64 + rg * 4);
      const float4 ga = *reinterpret_cast<const float4*>(gs + n * kTileR + og * 4);
      const float4 gb = *reinterpret_cast<const float4*>(gs + n * kTileR + 64 + og * 4);
      const float zv[8] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(zv[i], gv[j], acc[i][j]);
    }
  }

  float* dst = a.pdw + (size_t)blockIdx.y * k_rows * a.o;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r_base + (i < 4 ? rg * 4 + i : 64 + rg * 4 + i - 4);
    if (r >= k_rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int oc = o_base + (j < 4 ? og * 4 + j : 64 + og * 4 + j - 4);
      if (oc < a.o) dst[(size_t)r * a.o + oc] = acc[i][j];
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

int round8(int x) { return (x + 7) / 8 * 8; }

// Shared memory of a phase-1 block, in bytes, with W walked in chunks of
// o_chunk maps.
int cols_smem_bytes(int hk, int o, int o_chunk, int nwarps) {
  return (hk * kTileN + nwarps * kTileN) * (int)sizeof(float) +
         (o_chunk * round8(hk) + o * kGStride) * (int)sizeof(__nv_bfloat16);
}

// Column splits of phase 2: enough (row tile, map tile, split) blocks for
// two per SM, each split a whole number of column chunks.
int dw_splits(int k_rows, int o, int bd, int sms) {
  const int tiles = ((k_rows + kTileR - 1) / kTileR) * ((o + 127) / 128);
  int s = (2 * sms + tiles - 1) / tiles;
  const int nchunks = (bd + kChunk - 1) / kChunk;
  if (s > nchunks) s = nchunks;
  return s < 1 ? 1 : s;
}

}  // namespace

// Column splits of K5's dW phase for a card with `sms` SMs (the wrapper
// sizes its partial-dW scratch by them).
extern "C" int cin_interact_bwd_splits(int h0, int hk, int o, int bd, int sms) {
  return dw_splits(h0 * hk, o, bd, sms);
}

// Launches K5 on `stream`: phases 1, 2 and 3. x0 (h0, bd) f32, xk (hk,
// bd) f32, wt (h0, o, roundup8(hk)) bf16 with wt[h][o][m] = W[h*hk + m, o]
// and padding 0, g (o, bd) f32. Scratch: gt (bd, roundup8(o)) bf16, pdw
// (splits, h0*hk, o) f32 with splits from cin_interact_bwd_splits. Out:
// dx0 (h0, bd), dxk (hk, bd), dw (h0*hk, o), all f32. Returns
// cudaGetLastError() after the launches (or cudaErrorInvalidValue for a
// geometry outside the kernel's range).
extern "C" int cin_interact_bwd(const void* x0, const void* xk, const void* wt, const void* g,
                                void* gt, void* pdw, int splits, void* dx0, void* dxk,
                                void* dw, int h0, int hk, int o, int bd, void* stream) {
  if (h0 < 1 || hk < 1 || hk > 128 || o < 1 || o > 512 || bd < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ColsArgs a;
  a.x0 = static_cast<const float*>(x0);
  a.xk = static_cast<const float*>(xk);
  a.wt = static_cast<const __nv_bfloat16*>(wt);
  a.g = static_cast<const float*>(g);
  a.gt = static_cast<__nv_bfloat16*>(gt);
  a.dx0 = static_cast<float*>(dx0);
  a.dxk = static_cast<float*>(dxk);
  a.h0 = h0;
  a.hk = hk;
  a.hk_pad = round8(hk);
  a.o = o;
  a.o_pad = round8(o);
  a.bd = bd;
  a.nwarps = (hk + kRows - 1) / kRows;
  if (a.nwarps < kMinWarps) a.nwarps = kMinWarps;
  a.o_chunk = a.o_pad;
  while (a.o_chunk > 8 && cols_smem_bytes(hk, o, a.o_chunk, a.nwarps) > kMaxSmem)
    a.o_chunk -= 8;
  const int smem1 = cols_smem_bytes(hk, o, a.o_chunk, a.nwarps);
  if (smem1 > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cin_interact_bwd_cols, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  cin_interact_bwd_cols<<<(bd + kTileN - 1) / kTileN, 32 * a.nwarps, smem1, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  DwArgs b;
  b.x0 = a.x0;
  b.xk = a.xk;
  b.gt = a.gt;
  b.pdw = static_cast<float*>(pdw);
  b.h0 = h0;
  b.hk = hk;
  b.o = o;
  b.o_pad = a.o_pad;
  b.bd = bd;
  b.splits = splits;
  const int k_rows = h0 * hk;
  const int nh_max = (kTileR / hk + 2 < h0) ? kTileR / hk + 2 : h0;
  const int smem2 = (2 * kChunk * kTileR + (nh_max + hk) * kStage) * (int)sizeof(float);
  err = cudaFuncSetAttribute(cin_interact_bwd_dw,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((k_rows + kTileR - 1) / kTileR, splits, (o + 127) / 128);
  cin_interact_bwd_dw<<<grid, 256, smem2, st>>>(b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_dw = k_rows * o;
  cin_interact_bwd_reduce<<<(n_dw + 255) / 256, 256, 0, st>>>(b.pdw, splits, n_dw,
                                                              static_cast<float*>(dw));
  return (int)cudaGetLastError();
}
