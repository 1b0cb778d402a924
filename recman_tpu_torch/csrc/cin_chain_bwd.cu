// K2: the whole CIN tower backward, from the pooled cotangents and the
// fmaps that K1 saved.
//
// Replaces the TPU kernel recman_tpu/ops/cin_chain.py:_chain_bwd_kernel
// in its save-fmaps form (launched from _chain_bwd_pallas with fmaps).
// Bound to PyTorch through a plain C interface (ctypes); the wrapper is
// recman_tpu_torch/ops/cin_chain.py:cin_chain_bwd.
//
// What it computes, per column n = b*D + d, walking the layers in reverse
// (reference ops/cin_chain.py:286-355):
//   dfmap_i = [dxk from layer i+1 (its first O_i/2 rows) ; g_i[b, :]]
//   gpre_i  = dfmap_i * act'(fmap_i), act' read from the saved fmap
//   db_i   += sum_n gpre_i
//   dW_i   += z_i . bf16(gpre_i)^T,  z_i[h*Hk+m] = bf16(bf16(x0[h]) * bf16(xk[m]))
//   u_i     = bf16(W_i) . bf16(gpre_i)                       (f32 sums)
//   dx0[h] += sum_m u_i[h*Hk+m] * xk[m],  dxk[m] += sum_h u_i[h*Hk+m] * x0[h]
// with x0 and xk entering the last two lines in f32, not rounded; layer
// 0's dxk folds into dx0. xk is x0 for layer 0 and the first Hk_i rows of
// fmap_{i-1} after it. Every bf16 rounding above is one the reference
// makes, at the same place.
//
// Bound on an H100 SXM: operations. At the training geometry (H0 = 26,
// units (100, 100), D = 16, B = 8192) dW and u each take 51.8 GFLOP of
// bf16 products, 103.6 GFLOP in all: 0.105 ms at the 989 TFLOP/s bf16
// tensor-core peak. The bytes (the fmaps 104.9 MB, x0c and dx0 13.6 MB
// each, the pooled cotangents 4.9 MB) take 0.041 ms at 3.35 TB/s.
//
// Design (simple and deterministic first; tensor cores are later work):
// - The TPU kernel carries dW and db in VMEM across its sequential grid.
//   Blocks on the card run in no order, so the work splits in two
//   phases, with no atomics, each sum in a fixed order:
//   1. cin_chain_bwd_cols: everything except dW is local to a column, so
//      a block owns 128 columns (128/D whole batch rows, as in K1) and
//      walks the layers. It computes gpre, writes it rounded to bf16 and
//      transposed, (B*D, O_pad), for phase 2, writes its partial db per
//      map, and keeps dx0 and the dxk chain in shared memory and
//      registers. u for a whole layer is K_i x 128 f32 (665 KB at K =
//      1300), too big for shared memory, so it is formed one field h at a
//      time (Hk rows x 128 columns, the reference's loop over groups) and
//      folded into dx0[h] and dxk at once. gpre is kept in bf16 (exact:
//      it is rounded already) and W is walked in chunks of maps sized to
//      fit, so the widest geometry K1 takes fits too; at the training
//      geometry one chunk holds all maps and a block takes 105 KB. Warp w owns rows [8w, 8w+8) of
//      u and their dxk, each lane 4 consecutive columns.
//   2. cin_chain_bwd_dw: dW_i = z_i . gpre_i^T over all B*D columns. A
//      block owns 128 rows and 128 maps of dW and one split of the
//      columns; it rebuilds its z rows in shared memory from x0 and the
//      saved xk rows, 64 columns at a time, and writes a partial dW per
//      split.
//   3. cin_chain_bwd_reduce: dW = the sum of the split partials and db
//      the sum of the block partials, both in index order.
// - The products run on the CUDA cores in f32. Every product is of two
//   bf16 values (or is an f32 product the reference also forms in f32),
//   so only the order of the f32 sums differs from the plain version.
//
// Geometry taken (the wrapper checks and raises outside it): K1's range
// (D divides 128, B*D a multiple of 128, at most 8 layers, O_i <= 256,
// non-final O_i even, H0 and Hk_i <= 128) and shared memory <= 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kTileN = 128;   // B*D columns per block of phase 1
constexpr int kRows = 8;      // rows of u per warp
constexpr int kMinWarps = 4;
constexpr int kGStride = 132; // floats per gpre row in shared memory
constexpr int kTileR = 128;   // dW rows per block of phase 2
constexpr int kChunk = 64;    // columns per step of phase 2
constexpr int kStage = kChunk + 1;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

struct ColsArgs {
  const float* x0c;  // (h0, bd) f32
  int h0, bd, d, n_layers, act, o_total, nwarps;
  int max_hk, max_o, o_chunk, max_hk_pad;
  int hk[kMaxLayers], o[kMaxLayers], feed[kMaxLayers], hk_pad[kMaxLayers];
  int o_pad[kMaxLayers], db_off[kMaxLayers];
  const __nv_bfloat16* wt[kMaxLayers];  // (h0, o, hk_pad) bf16: [h][o][m] = W[h*hk+m, o]
  const float* fmap[kMaxLayers];        // (o, bd) f32
  const float* g[kMaxLayers];           // (bd/d, o - feed) f32
  __nv_bfloat16* gt[kMaxLayers];        // (bd, o_pad) bf16: bf16(gpre) transposed
  float* pdb;                           // (bd/128, o_total) f32
  float* dx0;                           // (h0, bd) f32
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float act_deriv(float fmap, int act) {
  if (act == 1) return fmap > 0.0f ? 1.0f : 0.0f;
  if (act == 2) return fmap > 0.0f ? 1.0f : 0.2f;
  return 1.0f;
}

__global__ void __launch_bounds__(512) cin_chain_bwd_cols(const ColsArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* x0s = smem;                          // h0 x 128, f32
  float* dx0s = x0s + a.h0 * kTileN;          // h0 x 128
  float* xks = dx0s + a.h0 * kTileN;          // max_hk x 128: xk, or dxk handed down
  float* wts = xks + a.max_hk * kTileN;       // o_chunk x hk_pad: a chunk of one field's W
  float* red = wts + a.o_chunk * a.max_hk_pad;  // nwarps x 128: partial dx0 sums
  __nv_bfloat16* gps =                        // max_o x kGStride: bf16(gpre), exact
      reinterpret_cast<__nv_bfloat16*>(red + a.nwarps * kTileN);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = lane * 4;
  const int col0 = blockIdx.x * kTileN;
  const int row0 = col0 / a.d;

  for (int i = tid; i < a.h0 * (kTileN / 4); i += nthreads) {
    const int h = i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
    *reinterpret_cast<float4*>(x0s + h * kTileN + c) =
        *reinterpret_cast<const float4*>(a.x0c + (size_t)h * a.bd + col0 + c);
    *reinterpret_cast<float4*>(dx0s + h * kTileN + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float dxk[kRows][4];
  for (int l = a.n_layers - 1; l >= 0; --l) {
    const int hk = a.hk[l], o = a.o[l], feed = a.feed[l], hk_pad = a.hk_pad[l];
    const int nd = o - feed;
    __syncthreads();  // x0s loaded; the dxk handed down by layer l+1 is in xks

    // gpre, its bf16 rounding and this block's partial db, one map per warp
    for (int r = warp; r < o; r += a.nwarps) {
      const float4 f = *reinterpret_cast<const float4*>(
          a.fmap[l] + (size_t)r * a.bd + col0 + n0);
      const float fv[4] = {f.x, f.y, f.z, f.w};
      float gp[4];
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float df = r < feed
            ? xks[r * kTileN + n0 + c]
            : a.g[l][(size_t)(row0 + (n0 + c) / a.d) * nd + (r - feed)];
        gp[c] = a.act == 0 ? df : df * act_deriv(fv[c], a.act);
      }
      s = (gp[0] + gp[1]) + (gp[2] + gp[3]);
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) a.pdb[(size_t)blockIdx.x * a.o_total + a.db_off[l] + r] = s;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(gps + r * kGStride + n0);
      dst[0] = __floats2bfloat162_rn(gp[0], gp[1]);
      dst[1] = __floats2bfloat162_rn(gp[2], gp[3]);
    }
    __syncthreads();  // gpre complete; the handed-down dxk is consumed

    // bf16(gpre) transposed to (bd, o_pad) for the dW phase, padding maps 0
    const int o_pad = a.o_pad[l];
    for (int i = tid; i < kTileN * (o_pad / 2); i += nthreads) {
      const int n = i / (o_pad / 2), r = (i % (o_pad / 2)) * 2;
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
      __nv_bfloat162 v;
      v.x = r < o ? gps[r * kGStride + n] : zero;
      v.y = r + 1 < o ? gps[(r + 1) * kGStride + n] : zero;
      *reinterpret_cast<__nv_bfloat162*>(a.gt[l] + (size_t)(col0 + n) * o_pad + r) = v;
    }
    // this layer's xk, f32 as saved: x0 for layer 0, fmap_{l-1}[:hk] after
    for (int i = tid; i < hk * (kTileN / 4); i += nthreads) {
      const int m = i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
      const float4 v = l == 0
          ? *reinterpret_cast<const float4*>(x0s + m * kTileN + c)
          : *reinterpret_cast<const float4*>(a.fmap[l - 1] + (size_t)m * a.bd + col0 + c);
      *reinterpret_cast<float4*>(xks + m * kTileN + c) = v;
    }

    const int m0 = warp * kRows;
    const bool active = m0 < hk;                // warp-uniform
    const int nact = (hk + kRows - 1) / kRows;  // warps that own rows
#pragma unroll
    for (int j = 0; j < kRows; ++j) dxk[j][0] = dxk[j][1] = dxk[j][2] = dxk[j][3] = 0.0f;

    for (int h = 0; h < a.h0; ++h) {
      float acc[kRows][4];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      for (int oc0 = 0; oc0 < o; oc0 += a.o_chunk) {
        const int oc = min(a.o_chunk, o - oc0);
        __syncthreads();  // the previous W chunk and partial sums are consumed
        const uint4* wsrc =
            reinterpret_cast<const uint4*>(a.wt[l] + ((size_t)h * o + oc0) * hk_pad);
        for (int i = tid; i < oc * hk_pad / 8; i += nthreads) {
          const uint4 u = __ldg(wsrc + i);
          float4* dst = reinterpret_cast<float4*>(wts + i * 8);
          dst[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                               __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
          dst[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                               __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
        }
        __syncthreads();
        if (active) {
#pragma unroll 2
          for (int r = 0; r < oc; ++r) {
            const uint2 gu = *reinterpret_cast<const uint2*>(gps + (oc0 + r) * kGStride + n0);
            const float gv[4] = {__uint_as_float(gu.x << 16), __uint_as_float(gu.x & 0xffff0000u),
                                 __uint_as_float(gu.y << 16), __uint_as_float(gu.y & 0xffff0000u)};
            const float4 wa = *reinterpret_cast<const float4*>(wts + r * hk_pad + m0);
            const float4 wb = *reinterpret_cast<const float4*>(wts + r * hk_pad + m0 + 4);
            const float wv[kRows] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
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
        const float4 xv = *reinterpret_cast<const float4*>(x0s + h * kTileN + n0);
        const float x0v[4] = {xv.x, xv.y, xv.z, xv.w};
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int m = m0 + j;
          if (m < hk) {
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
        dx0s[h * kTileN + i] += s;
      }
    }
    __syncthreads();  // every read of this layer's xk and every dx0s update is done
    if (active) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int m = m0 + j;
        if (m >= hk) break;
        float* dst = (l == 0 ? dx0s : xks) + m * kTileN + n0;
        float4 v = l == 0 ? *reinterpret_cast<float4*>(dst) : make_float4(0.f, 0.f, 0.f, 0.f);
        v.x += dxk[j][0];
        v.y += dxk[j][1];
        v.z += dxk[j][2];
        v.w += dxk[j][3];
        *reinterpret_cast<float4*>(dst) = v;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < a.h0 * (kTileN / 4); i += nthreads) {
    const int h = i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
    *reinterpret_cast<float4*>(a.dx0 + (size_t)h * a.bd + col0 + c) =
        *reinterpret_cast<const float4*>(dx0s + h * kTileN + c);
  }
}

struct DwArgs {
  const float* x0c;             // (h0, bd) f32
  const float* xk;              // (>= hk, bd) f32: x0c or the previous fmap
  const __nv_bfloat16* gt;      // (bd, o_pad) bf16
  float* pdw;                   // (splits, h0*hk, o) f32
  int h0, hk, o, o_pad, bd, splits;
};

__global__ void __launch_bounds__(256) cin_chain_bwd_dw(const DwArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* zs = smem;                       // kChunk x kTileR: z[n][r]
  float* gs = zs + kChunk * kTileR;       // kChunk x 128:    gpre[n][o_base + o]
  float* stage = gs + kChunk * kTileR;    // (nh + hk) x kStage: bf16(x0), bf16(xk)

  const int tid = threadIdx.x;
  const int k_rows = a.h0 * a.hk;
  const int r_base = blockIdx.x * kTileR;
  const int o_base = blockIdx.z * 128;
  const int h_lo = r_base / a.hk;
  const int h_hi = min(a.h0 - 1, (r_base + kTileR - 1) / a.hk);
  const int nh = h_hi - h_lo + 1;
  const int nchunks = a.bd / kChunk;
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
      const int row = i / kChunk, n = i % kChunk;
      const float v = row < nh ? a.x0c[(size_t)(h_lo + row) * a.bd + c0 + n]
                               : a.xk[(size_t)(row - nh) * a.bd + c0 + n];
      stage[row * kStage + n] = bf16_round(v);
    }
    for (int i = tid; i < kChunk * 16; i += blockDim.x) {
      const int n = i / 16, q = (i % 16) * 8;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (o_base + q < a.o_pad) {
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

// dw[i] = sum over splits of pdw[s][i], db[j] = sum over blocks of
// pdb[b][off + j], both in index order.
__global__ void cin_chain_bwd_reduce(const float* pdw, int splits, int n_dw, float* dw,
                                     const float* pdb, int blocks, int o_total, int off,
                                     int o, float* db) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_dw) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += pdw[(size_t)k * n_dw + i];
    dw[i] = s;
  } else if (i < n_dw + o) {
    const int j = i - n_dw;
    float s = 0.0f;
    for (int b = 0; b < blocks; ++b) s += pdb[(size_t)b * o_total + off + j];
    db[j] = s;
  }
}

int round8(int x) { return (x + 7) / 8 * 8; }

// Shared memory of a phase-1 block, in bytes, with W walked in chunks of
// o_chunk maps.
int cols_smem_bytes(int h0, int max_hk, int max_hk_pad, int max_o, int o_chunk, int nwarps) {
  return ((2 * h0 + max_hk) * kTileN + o_chunk * max_hk_pad + nwarps * kTileN) *
             (int)sizeof(float) +
         max_o * kGStride * (int)sizeof(__nv_bfloat16);
}

// Phase 1's block: one warp per 8 rows of the widest fan-in (at least
// kMinWarps) and the widest W chunk that fits (all maps at the training
// geometry). smem may exceed kMaxSmem: the geometry is then refused.
struct ColsPlan {
  int max_hk, max_o, nwarps, o_chunk, smem;
};

ColsPlan cols_plan(int h0, int n_layers, const int* units) {
  ColsPlan p;
  p.max_hk = p.max_o = 0;
  int hk = h0;
  for (int l = 0; l < n_layers; ++l) {
    if (hk > p.max_hk) p.max_hk = hk;
    if (units[l] > p.max_o) p.max_o = units[l];
    hk = units[l] / 2;
  }
  p.nwarps = (p.max_hk + kRows - 1) / kRows;
  if (p.nwarps < kMinWarps) p.nwarps = kMinWarps;
  const int hk_pad = round8(p.max_hk);
  p.o_chunk = round8(p.max_o);
  while (p.o_chunk > 8 &&
         cols_smem_bytes(h0, p.max_hk, hk_pad, p.max_o, p.o_chunk, p.nwarps) > kMaxSmem)
    p.o_chunk -= 8;
  p.smem = cols_smem_bytes(h0, p.max_hk, hk_pad, p.max_o, p.o_chunk, p.nwarps);
  return p;
}

// Column splits of phase 2 for a layer with k_rows rows of dW: enough
// (row tile, split) blocks for two per SM, each split a whole number of
// column chunks.
int dw_splits(int k_rows, int bd, int sms) {
  const int tiles = (k_rows + kTileR - 1) / kTileR;
  int s = (2 * sms + tiles - 1) / tiles;
  if (s > bd / kChunk) s = bd / kChunk;
  return s < 1 ? 1 : s;
}

}  // namespace

// K2's launch plan for a geometry inside K1's range: fills splits[l], the
// column splits of layer l's dW phase (the wrapper sizes its partial-dW
// scratch by them), for a card with `sms` SMs, and returns the shared
// memory of a phase-1 block in bytes (over 232448 means K2 refuses the
// geometry). A phase-2 block needs under 100 KB for any such geometry.
extern "C" int cin_chain_bwd_plan(int h0, int bd, int n_layers, const int* units, int sms,
                                  int* splits) {
  int hk = h0;
  for (int l = 0; l < n_layers; ++l) {
    splits[l] = dw_splits(h0 * hk, bd, sms);
    hk = units[l] / 2;
  }
  return cols_plan(h0, n_layers, units).smem;
}

// Launches K2 on `stream`: phase 1 once, then phase 2 and the reduction
// once per layer. x0c (h0, bd) f32; wt[l] (h0, units[l], roundup8(hk_l))
// bf16 with wt[l][h][o][m] = W_l[h*hk_l + m, o] and padding 0; fmap[l]
// (units[l], bd) f32 from K1; g[l] (bd/d, F_l) f32 pooled cotangents.
// Scratch: gt[l] (bd, roundup8(units[l])) bf16; pdb (bd/128, sum units)
// f32; pdw[l] (splits[l], h0*hk_l, units[l]) f32. Out: dx0 (h0, bd),
// dw[l] (h0*hk_l, units[l]), db[l] (units[l],), all f32. act: 0 identity,
// 1 relu, 2 leaky_relu. Returns cudaGetLastError() after the launches (or
// cudaErrorInvalidValue for a geometry outside the kernel's range).
extern "C" int cin_chain_bwd(const void* x0c, int h0, int bd, int d, int n_layers,
                             const int* units, const void* const* wt,
                             const void* const* fmap, const void* const* g,
                             void* const* gt, void* pdb, void* const* pdw,
                             const int* splits, void* dx0, void* const* dw,
                             void* const* db, int act, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || h0 < 1 || h0 > 128 || d < 1 ||
      kTileN % d != 0 || bd % kTileN != 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ColsArgs a;
  a.x0c = static_cast<const float*>(x0c);
  a.h0 = h0;
  a.bd = bd;
  a.d = d;
  a.n_layers = n_layers;
  a.act = act;
  a.o_total = 0;
  int hk = h0;
  for (int l = 0; l < n_layers; ++l) {
    const int o = units[l];
    const bool final_layer = l == n_layers - 1;
    if (o < 1 || o > 256 || (!final_layer && o % 2 != 0) || hk > 128 || splits[l] < 1)
      return (int)cudaErrorInvalidValue;
    a.hk[l] = hk;
    a.o[l] = o;
    a.feed[l] = final_layer ? 0 : o / 2;
    a.hk_pad[l] = round8(hk);
    a.o_pad[l] = round8(o);
    a.db_off[l] = a.o_total;
    a.o_total += o;
    a.wt[l] = static_cast<const __nv_bfloat16*>(wt[l]);
    a.fmap[l] = static_cast<const float*>(fmap[l]);
    a.g[l] = static_cast<const float*>(g[l]);
    a.gt[l] = static_cast<__nv_bfloat16*>(gt[l]);
    hk = o / 2;
  }
  a.pdb = static_cast<float*>(pdb);
  a.dx0 = static_cast<float*>(dx0);
  const ColsPlan plan = cols_plan(h0, n_layers, units);
  a.max_hk = plan.max_hk;
  a.max_o = plan.max_o;
  a.max_hk_pad = round8(plan.max_hk);
  a.nwarps = plan.nwarps;
  a.o_chunk = plan.o_chunk;
  const int smem1 = plan.smem;
  if (smem1 > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cin_chain_bwd_cols, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  const int blocks = bd / kTileN;
  cin_chain_bwd_cols<<<blocks, 32 * a.nwarps, smem1, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  for (int l = 0; l < n_layers; ++l) {
    DwArgs b;
    b.x0c = a.x0c;
    b.xk = l == 0 ? a.x0c : a.fmap[l - 1];
    b.gt = a.gt[l];
    b.pdw = static_cast<float*>(pdw[l]);
    b.h0 = h0;
    b.hk = a.hk[l];
    b.o = a.o[l];
    b.o_pad = a.o_pad[l];
    b.bd = bd;
    b.splits = splits[l];
    const int k_rows = h0 * b.hk;
    const int nh_max = (kTileR / b.hk + 2 < h0) ? kTileR / b.hk + 2 : h0;
    const int smem2 = (2 * kChunk * kTileR + (nh_max + b.hk) * kStage) * (int)sizeof(float);
    err = cudaFuncSetAttribute(cin_chain_bwd_dw,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((k_rows + kTileR - 1) / kTileR, b.splits, (b.o + 127) / 128);
    cin_chain_bwd_dw<<<grid, 256, smem2, st>>>(b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_dw = k_rows * b.o;
    cin_chain_bwd_reduce<<<(n_dw + b.o + 255) / 256, 256, 0, st>>>(
        b.pdw, b.splits, n_dw, static_cast<float*>(dw[l]), a.pdb, blocks, a.o_total,
        a.db_off[l], b.o, static_cast<float*>(db[l]));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
