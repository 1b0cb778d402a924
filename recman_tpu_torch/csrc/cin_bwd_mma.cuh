// Tensor-core code of the CIN backward shared by K5 (cin_interact_bwd.cu,
// one layer) and K2 (cin_chain_bwd.cu, the whole chain): the column-local
// field loop (u = W_h . gb folded into dx0 and dxk) and the dW contraction
// dW = z . gb^T over column splits. In K5, gb is bf16(g); in K2 it is
// bf16(gpre), the cotangent after the activation's derivative.
//
// The field loop. A block owns 128 columns and runs 16 warps: 8 groups of
// 16 columns, each split in two halves of Hk's n8 tiles, so that u, dxk
// and xk of a thread fit its 128 registers. For each field h it forms u_h^T
// (columns x Hk8) = gb^T (columns x O16) . W_h^T (O16 x Hk8): M the
// columns, N = Hk rounded up to 8, K = O rounded up to 16. A (gb^T) comes
// from the block's gb in shared memory, gs[o][n] (O16 x kGStride bf16,
// zero past O), through ldmatrix.trans; B (W_h) streams through a 3-stage
// cp.async ring of the layout Wp[h*Hk8 + m][o] = bf16(W[h*Hk+m, o]) (Hk8 =
// Hk rounded up to 8, O64 = O rounded up to 64, padding zero), `sw` maps a
// stage (a multiple of 64: a whole field where shared memory allows). A
// k-step loads all its fragments before its products, so the loads
// overlap. The fold runs on the accumulator fragments, in f32: dx0[h, n]
// is an in-thread sum over the thread's m, a shuffle sum over the 4
// threads that share the column, and the sum of the two halves' partials
// in shared memory, in that order (the caller's dx0_store(h) reads them,
// after the next barrier); dxk[m, n] += u * x0[h, n] stays in registers,
// in the same fragment layout, across every h.
//
// The dW contraction (cin_bwd_dw). M = the X rows of dW, N = the maps, K
// = the columns. A block owns 128 rows x 128 maps and one split of the
// columns; 8 warps as 4 (rows) x 2 (maps), each 32 x 64. Each 64-column
// slice of the x0 rows its z rows need, of xk, and of gb's 128 maps
// streams through a 3-stage cp.async ring; x0 and xk come as bf16 copies
// (K5's scratch) or as the f32 rows themselves (K2: x0c and the feed rows,
// so no copy is stored), which the block then rounds once per slice into
// a bf16 tile. Every thread builds its A fragment of z in registers from
// two 32-bit loads of bf16 pairs and one bf16x2 multiply, with its rows'
// (h, m) offsets computed once per block (no divide in the loop); B comes
// through ldmatrix. Each split writes its own partial dW, which the
// caller sums in split order.
//
// Both loops split their sums: mma.sync adds a product's terms to its
// accumulator with truncation, so one accumulation over a long k-loop
// drifts (cin_fwd_mma.cuh). u (K = the maps) takes kUSplit k16 steps
// into a fresh fragment, dW (K = the columns, thousands of steps at B*D
// 40,960) one step, and a rounded f32 add puts each on the running sum.
// One accumulation put K5's dW 26.3x and dx0/dxk 4.8x the plain twin's
// gap to the exact sums, K2's final dW 6.8x; split so, they are within
// 2x over the card tests' geometries (tools/chain_readings.py
// dw_accuracy; PERF.md). A coarser split of dW missed that bound at a
// 64-column geometry, and re-reads B's fragments for each row tile.

#pragma once

#include "tensor_core.cuh"

namespace {
namespace cinbwd {

constexpr int kThreads = 256;        // the dW contraction's block
constexpr int kStages = 3;
constexpr int kSlice = 64;           // dW's columns a stage; the field loop's W slices are multiples
constexpr int kStride = kSlice + 8;  // bf16 per staged row of dW: 144 B, ldmatrix without conflicts
constexpr int kCols = 128;           // B*D columns per block of the field loop
constexpr int kColsThreads = 512;    // 16 warps: 8 groups of 16 columns x 2 halves of Hk
constexpr int kGStride = kCols + 8;  // bf16 per staged gb row
constexpr int kDwRows = 128;         // dW rows per block
constexpr int kDwMaps = 128;         // dW maps per block
constexpr int kMaxSmem = 232448;     // bytes of shared memory a block may use
// k16 steps of the field loop's u per fresh fragment (see the top)
constexpr int kUSplit = 4;

inline __host__ __device__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Bytes of one field loop's W ring: 3 stages of hk8 rows of sw maps.
inline int ring_bytes(int hk8, int sw) { return kStages * hk8 * (sw + 8) * 2; }

// A field-loop thread's place: its warp's half of Hk's n8 tiles ([j0, j0
// + ntw) of hk8 / 8) and its two columns ca and cb = ca + 8 of its 16
// (rows g and g + 8 of its fragments).
struct ColsThread {
  int g, q, half, wc, j0, ntw, ca, cb;
  bool va, vb;
};

__device__ __forceinline__ ColsThread cols_thread(int hk8, int bd) {
  ColsThread t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  t.g = lane >> 2;
  t.q = lane & 3;
  t.half = warp >> 3;
  t.wc = (warp & 7) * 16;
  const int nt = hk8 / 8, t0 = (nt + 1) / 2;
  t.j0 = t.half ? t0 : 0;
  t.ntw = t.half ? nt - t0 : t0;
  t.ca = blockIdx.x * kCols + t.wc + t.g;
  t.cb = t.ca + 8;
  t.va = t.ca < bd;
  t.vb = t.cb < bd;
  return t;
}

// The field loop's W ring: item it = h * noc + oc is W_h's maps [oc*sw,
// oc*sw + sw) (up to o16), all hk8 rows, in stage it % kStages.
struct WRing {
  __nv_bfloat16* ring;
  const __nv_bfloat16* wp;  // Wp (h0*hk8, o64)
  int hk8, o16, o64, sw, noc, items, ws_stride, stage_elems;

  __device__ WRing(__nv_bfloat16* ring_, const __nv_bfloat16* wp_, int h0, int hk8_, int o16_,
                   int o64_, int sw_)
      : ring(ring_), wp(wp_), hk8(hk8_), o16(o16_), o64(o64_), sw(sw_) {
    noc = (o16 + sw - 1) / sw;  // W slices per field
    items = h0 * noc;
    ws_stride = sw + 8;         // 16 mod 128 bytes: ldmatrix without conflicts
    stage_elems = hk8 * ws_stride;
  }

  __device__ void load(int it) const {
    const int h = it / noc, oc = it - h * noc;
    const int pieces = min(sw, o16 - oc * sw) / 8;  // 16 B pieces of a row
    __nv_bfloat16* dst = ring + (it % kStages) * stage_elems;
    const __nv_bfloat16* src = wp + (size_t)h * hk8 * o64 + oc * sw;
    for (int i = threadIdx.x; i < hk8 * pieces; i += kColsThreads) {
      const int r = i / pieces, p = (i - r * pieces) * 8;
      tc::cp_async16(dst + r * ws_stride + p, src + (size_t)r * o64 + p);
    }
  }

  // the first kStages - 1 items, one commit group each
  __device__ void prologue() const {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < items) load(s);
      tc::cp_async_commit();
    }
  }
};

// The field loop over h = 0..h0-1 (see the top), after w.prologue(). gs
// holds gb of the block's columns (o16 rows, zero past O); x0 (h0, bd)
// f32; xkr this thread's xk in the fragment layout of dxk; red 4 x 128 f32
// of shared memory; dx0_store(h) is called once per field, after the
// barrier that follows the field's partials (the last one after the
// loop's final barrier). Every thread of the block calls it: it
// synchronises. On return the ring is free.
template <int NTW, class Dx0Store>
__device__ __forceinline__ void fold_fields(const WRing& w, const __nv_bfloat16* gs, float* red,
                                            const float* x0, int bd, int h0,
                                            const float (&xkr)[NTW][4], float (&dxk)[NTW][4],
                                            Dx0Store&& dx0_store) {
  const int lane = threadIdx.x & 31;
  const ColsThread t = cols_thread(w.hk8, bd);
  const int noc = w.noc, items = w.items, ws_stride = w.ws_stride, sw = w.sw, o16 = w.o16;

  // ldmatrix addresses. A (.trans from gs[o][n]): lane l gives row o = 8 *
  // (l / 16) + l % 8 and column 8 * ((l / 8) % 2) of the warp's 16. B (from
  // the staged W_h[m][o]): row m = 8 * (l / 16) + l % 8, column 8 * ((l / 8) % 2).
  const __nv_bfloat16* a_src = gs + (((lane >> 4) << 3) + (lane & 7)) * kGStride + t.wc +
                               ((lane >> 3) & 1) * 8;
  const int b_off = (8 * t.j0 + ((lane >> 4) << 3) + (lane & 7)) * ws_stride +
                    ((lane >> 3) & 1) * 8;
  const int b_off2 = (8 * t.j0 + (lane & 7)) * ws_stride + ((lane >> 3) & 1) * 8;  // the .x2 form
  const int ntw = t.ntw;

  int it = 0;
  for (int h = 0; h < h0; ++h) {
    const float x0_a = t.va ? x0[(size_t)h * bd + t.ca] : 0.0f;
    const float x0_b = t.vb ? x0[(size_t)h * bd + t.cb] : 0.0f;
    float u[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) u[j][0] = u[j][1] = u[j][2] = u[j][3] = 0.0f;
    for (int oc = 0; oc < noc; ++oc, ++it) {
      tc::cp_async_wait<kStages - 2>();
      __syncthreads();  // item it has landed; the stage item it - 1 used is free
      if (oc == 0 && h > 0) dx0_store(h - 1);
      if (it + kStages - 1 < items) w.load(it + kStages - 1);
      tc::cp_async_commit();
      const __nv_bfloat16* ws = w.ring + (it % kStages) * w.stage_elems;
      const int steps = min(sw, o16 - oc * sw) / 16;
      // every fragment of a k-step first, then its products: the loads
      // overlap, and the tensor pipe gets the products back to back
      auto load = [&](int ks, uint32_t (&af)[4], uint32_t (&bf)[NTW][2]) {
        tc::ldmatrix_x4_trans(af, a_src + (oc * sw + ks * 16) * kGStride);
#pragma unroll
        for (int j = 0; j < NTW; j += 2) {
          if (j + 1 < NTW && j + 1 < ntw) {
            uint32_t r[4];
            tc::ldmatrix_x4(r, ws + j * 8 * ws_stride + b_off + ks * 16);
            bf[j][0] = r[0];
            bf[j][1] = r[1];
            bf[j + 1][0] = r[2];
            bf[j + 1][1] = r[3];
          } else if (j < ntw) {
            tc::ldmatrix_x2(bf[j], ws + j * 8 * ws_stride + b_off2 + ks * 16);
          }
        }
      };
      // kUSplit k-steps into a fresh fragment, added to u with a rounded
      // add; sw is a multiple of 64 maps, so the groups of steps do not
      // depend on it
      for (int ks0 = 0; ks0 < steps; ks0 += kUSplit) {
        float part[NTW][4];
#pragma unroll
        for (int j = 0; j < NTW; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kUSplit; ++kk) {
          if (ks0 + kk >= steps) break;
          uint32_t af[4], bf[NTW][2];
          load(ks0 + kk, af, bf);
#pragma unroll
          for (int j = 0; j < NTW; ++j)
            if (j < ntw) tc::mma_bf16(part[j], af, bf[j]);
        }
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) u[j][e] += part[j][e];
      }
    }
    // fold field h: dx0 over m, dxk across h
    float pa = 0.0f, pb = 0.0f;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      pa = fmaf(u[j][0], xkr[j][0], pa);
      pa = fmaf(u[j][1], xkr[j][1], pa);
      pb = fmaf(u[j][2], xkr[j][2], pb);
      pb = fmaf(u[j][3], xkr[j][3], pb);
      dxk[j][0] = fmaf(u[j][0], x0_a, dxk[j][0]);
      dxk[j][1] = fmaf(u[j][1], x0_a, dxk[j][1]);
      dxk[j][2] = fmaf(u[j][2], x0_b, dxk[j][2]);
      dxk[j][3] = fmaf(u[j][3], x0_b, dxk[j][3]);
    }
    // the 4 threads of a column hold its 4 sets of m: a + b is b + a, so
    // every lane gets the same bits
    pa += __shfl_xor_sync(0xffffffffu, pa, 1);
    pa += __shfl_xor_sync(0xffffffffu, pa, 2);
    pb += __shfl_xor_sync(0xffffffffu, pb, 1);
    pb += __shfl_xor_sync(0xffffffffu, pb, 2);
    if (t.q == 0) {
      float* r = red + (h & 1) * 2 * kCols + t.half * kCols;
      r[t.wc + t.g] = pa;
      r[t.wc + t.g + 8] = pb;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  dx0_store(h0 - 1);
}

// The sum of field h's two halves of partial dx0 at this thread's
// columns, for the q == 0 threads of half 0 to store: red[h % 2] holds
// them after the barrier that follows field h.
__device__ __forceinline__ float2 dx0_partials(const float* red, int h, const ColsThread& t) {
  const float* r = red + (h & 1) * 2 * kCols;
  return make_float2(r[t.wc + t.g] + r[kCols + t.wc + t.g],
                     r[t.wc + t.g + 8] + r[kCols + t.wc + t.g + 8]);
}

// TX: the element of the x0 and xk rows, __nv_bfloat16 or float.
template <class TX>
struct DwArgs {
  const TX* x0;                // (h0, bdp)
  const TX* xk;                // (hk, bdp)
  const __nv_bfloat16* gb;     // (o, bdp) bf16
  float* pdw;                  // (splits, h0*hk, o) f32
  int h0, hk, o, bdp, splits, nh_max;
};

// Bytes of one dW ring stage: x0 rows [0, nh_max) and xk rows [nh_max,
// nh_max + hk) in TX, then gb's kDwMaps rows in bf16, each kSlice columns.
template <class TX>
inline __host__ __device__ int dw_stage_bytes(int nh_max, int hk) {
  return (nh_max + hk) * kStride * (int)sizeof(TX) + kDwMaps * kStride * 2;
}

// Bytes of the dW block's shared memory: the ring, and for f32 rows one
// bf16 tile of a slice's x0 and xk rows, which the block rounds them into.
template <class TX>
inline __host__ __device__ int dw_smem_bytes(int nh_max, int hk) {
  return kStages * dw_stage_bytes<TX>(nh_max, hk) +
         (sizeof(TX) == 2 ? 0 : (nh_max + hk) * kStride * 2);
}

template <class TX>
__global__ void __launch_bounds__(kThreads, 2) cin_bwd_dw(const DwArgs<TX> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kShift = sizeof(TX) == 2 ? 3 : 4;  // log2 of the 16 B pieces of an x0 or xk row
  constexpr int kPer = 16 / (int)sizeof(TX);        // elements a piece
  const int stage_bytes = dw_stage_bytes<TX>(a.nh_max, a.hk);
  const int xk_row0 = a.nh_max;
  const int gb_off = (a.nh_max + a.hk) * kStride * (int)sizeof(TX);  // bytes into a stage
  // f32 rows: the bf16 tile after the ring
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem + kStages * stage_bytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int k_rows = a.h0 * a.hk;
  const int r_base = blockIdx.x * kDwRows;
  const int o_base = blockIdx.z * kDwMaps;
  const int h_lo = r_base / a.hk;
  const int r_last = min(r_base + kDwRows, k_rows) - 1;
  const int nh = r_last / a.hk - h_lo + 1;
  const int nchunks = a.bdp / kSlice;
  const int c_begin = (int)((long long)nchunks * blockIdx.y / a.splits);
  const int c_end = (int)((long long)nchunks * (blockIdx.y + 1) / a.splits);
  const int nc = c_end - c_begin;

  auto load = [&](int i_c) {
    const int col = (c_begin + i_c) * kSlice;
    unsigned char* stage = smem + (i_c % kStages) * stage_bytes;
    TX* xs = reinterpret_cast<TX*>(stage);
    __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(stage + gb_off);
    const int nx = (nh + a.hk) << kShift;
    for (int i = tid; i < nx + kDwMaps * 8; i += kThreads) {
      if (i < nx) {
        const int rr = i >> kShift, p = (i & ((1 << kShift) - 1)) * kPer;
        if (rr < nh)
          tc::cp_async16(xs + rr * kStride + p, a.x0 + (size_t)(h_lo + rr) * a.bdp + col + p);
        else
          tc::cp_async16(xs + (xk_row0 + rr - nh) * kStride + p,
                         a.xk + (size_t)(rr - nh) * a.bdp + col + p);
      } else {
        const int r = (i - nx) >> 3, p = ((i - nx) & 7) * 8, o = o_base + r;
        tc::cp_async16(gs + r * kStride + p, a.gb + (size_t)(o < a.o ? o : 0) * a.bdp + col + p,
                       o < a.o ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nc) load(s);
    tc::cp_async_commit();
  }

  // the thread's z rows r_base + wm*32 + 16i + 8e + g: offsets of their x0
  // and xk rows in a stage (rows past X read row 0 and are not stored)
  int zx0[2][2], zxk[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r_base + wm * 32 + 16 * i + 8 * e + g;
      const int h = r < k_rows ? r / a.hk : h_lo, m = r < k_rows ? r - h * a.hk : 0;
      zx0[i][e] = (h - h_lo) * kStride + 2 * q;
      zxk[i][e] = (xk_row0 + m) * kStride + 2 * q;
    }
  // n8 tiles of this warp that hold a map below O (warp-uniform)
  int ntv = (a.o - o_base - wn * 64 + 7) / 8;
  ntv = ntv < 0 ? 0 : (ntv > 8 ? 8 : ntv);
  // the thread's ldmatrix row of gb, in bf16 elements from a stage's start
  const int b_off = gb_off / 2 + (wn * 64 + ((lane >> 4) << 3) + (lane & 7)) * kStride +
                    ((lane >> 3) & 1) * 8;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  for (int i_c = 0; i_c < nc; ++i_c) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // slice i_c has landed; the stage slice i_c - 1 used is free
    if (i_c + kStages - 1 < nc) load(i_c + kStages - 1);
    tc::cp_async_commit();
    const __nv_bfloat16* st =
        reinterpret_cast<const __nv_bfloat16*>(smem + (i_c % kStages) * stage_bytes);
    if constexpr (sizeof(TX) != 2) {
      // round the slice's f32 rows into the bf16 tile once, as the
      // reference rounds x0 and xk; the tile is free (the barrier above
      // follows every warp's products of the slice before)
      const float* xf = reinterpret_cast<const float*>(st);
      for (int i = tid; i < (nh + a.hk) * (kSlice / 4); i += kThreads) {
        const int rr = i >> 4, row = rr < nh ? rr : xk_row0 + rr - nh, c = (i & 15) * 4;
        *reinterpret_cast<uint2*>(xb + row * kStride + c) =
            tc::pack_bf16x4(*reinterpret_cast<const float4*>(xf + row * kStride + c));
      }
      __syncthreads();
    }
    if (ntv == 0) continue;
    const __nv_bfloat16* xs = sizeof(TX) == 2 ? st : xb;  // the slice's bf16 x0 and xk rows
    // the A fragment of row tile i at k16 step ks: z built in registers
    auto a_frag = [&](int i, int ks, uint32_t (&af)[4]) {
      const int k = ks * 16;
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          af[2 * kh + e] =
              tc::mul_bf16x2(*reinterpret_cast<const uint32_t*>(xs + zx0[i][e] + k + 8 * kh),
                             *reinterpret_cast<const uint32_t*>(xs + zxk[i][e] + k + 8 * kh));
    };
    auto b_frags = [&](int ks, uint32_t (&bf)[8][2]) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        if (j < ntv) {
          uint32_t r[4];
          tc::ldmatrix_x4(r, st + b_off + j * 8 * kStride + ks * 16);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
      }
    };
#pragma unroll
    for (int ks = 0; ks < kSlice / 16; ++ks) {
      uint32_t af[2][4], bf[8][2];
      a_frag(0, ks, af[0]);
      a_frag(1, ks, af[1]);
      b_frags(ks, bf);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < ntv)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // each product into a fresh fragment, added with a rounded add
            float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            tc::mma_bf16(p, af[i], bf[j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += p[e];
          }
    }
  }
  tc::cp_async_wait<0>();

  float* dst = a.pdw + (size_t)blockIdx.y * k_rows * a.o;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r_base + wm * 32 + 16 * i + 8 * e + g;
      if (r >= k_rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = o_base + wn * 64 + j * 8 + 2 * q;
        if (o < a.o) dst[(size_t)r * a.o + o] = acc[i][j][2 * e];
        if (o + 1 < a.o) dst[(size_t)r * a.o + o + 1] = acc[i][j][2 * e + 1];
      }
    }
}

// Column splits of phase 2: as many (row tile, map tile, split) blocks as
// two a SM can hold at once, each split a whole number of column slices.
inline int dw_splits(int k_rows, int o, int bd, int sms) {
  const int tiles = ((k_rows + kDwRows - 1) / kDwRows) * ((o + kDwMaps - 1) / kDwMaps);
  int s = 2 * sms / tiles;
  const int nchunks = round_up(bd, kSlice) / kSlice;
  if (s > nchunks) s = nchunks;
  return s < 1 ? 1 : s;
}


// Launches the dW contraction for one layer on `st`: x0 (h0, bdp) and xk
// (hk, bdp), bf16 or f32, and gb (o, bdp) bf16, with bdp a multiple of
// kSlice and zeros past the columns; pdw (splits, h0*hk, o) f32 partials.
template <class TX>
cudaError_t dw_launch(const TX* x0, const TX* xk, const __nv_bfloat16* gb, float* pdw, int h0,
                      int hk, int o, int bdp, int splits, cudaStream_t st) {
  DwArgs<TX> b;
  b.x0 = x0;
  b.xk = xk;
  b.gb = gb;
  b.pdw = pdw;
  b.h0 = h0;
  b.hk = hk;
  b.o = o;
  b.bdp = bdp;
  b.splits = splits;
  b.nh_max = (kDwRows - 1) / hk + 2 < h0 ? (kDwRows - 1) / hk + 2 : h0;
  const int k_rows = h0 * hk;
  const int smem = dw_smem_bytes<TX>(b.nh_max, hk);
  cudaError_t err =
      cudaFuncSetAttribute(cin_bwd_dw<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((k_rows + kDwRows - 1) / kDwRows, splits, (o + kDwMaps - 1) / kDwMaps);
  cin_bwd_dw<TX><<<grid, kThreads, smem, st>>>(b);
  return cudaGetLastError();
}

}  // namespace cinbwd
}  // namespace
