// The tensor-core k-loop of a CIN layer's forward, shared by K4
// (cin_interact_fwd.cu) and K1 (cin_chain_fwd.cuh):
//   pre (maps x 128 columns) += bf16(W)^T (maps x Kz) . z (Kz x 128 columns)
// with z[h*Hk8 + m, n] = bf16(bf16(x0[h, n]) * bf16(xk[m, n])) never stored.
//
// - A (bf16(W)^T) comes from Wt (O, Kp), Wt[o][h*Hk8 + m] = bf16(W[h*Hk+m,
//   o]), Hk8 = Hk rounded up to 8, padding zero, Kp a multiple of kBK:
//   k-slices of kBK stream through a ring of kStages stages (cp.async, two
//   in flight while one multiplies); ldmatrix reads the fragments.
// - B (z) is built in registers: x0 and xk of the block's columns sit in
//   shared memory as bf16, column-major (a column's rows contiguous), and
//   each B register is one 32-bit load of (xk[m], xk[m+1]), one 16-bit load
//   of x0[h] and one bf16x2 multiply. With Hk8 a multiple of 8, each 8
//   consecutive z rows belong to one field h, so (h, m) come from two
//   counters and never from a divide.
// - A warp owns 64 maps x 32 columns: 4 x 4 m16n8 tiles, 64 f32 sums a
//   thread, each summed in a fixed order.
// - The tensor cores add a product's terms to the accumulator with
//   truncation, not rounding, so over a long k-loop one accumulation
//   drifts from the exact sum further than an f32 matmul does. z_product
//   takes kSplit k16 steps into a fresh fragment and adds that to the
//   running sum with a rounded f32 add (0: one accumulation). K1 takes
//   pairs (kChainSplit 2): its feed rows round to bf16 inside the chain,
//   and on one accumulation K1 drifts up to 1.59e-3 of max|ref| from the
//   exact (f64) chain end to end, past its 1e-3 check, against 1.09e-3
//   with pairs. K4 takes a fresh fragment per ring slice (kSplit 4): one
//   accumulation put its output up to 24.9x the plain twin's gap to the
//   exact sums, slices 1.6x at most over the card tests' geometries
//   (chain_readings.py dw_accuracy), where pairs and single steps each
//   miss 2x at one geometry; 0.489 ms against 0.333 at the paper's layers
//   1-2 (pairs 0.479, single steps 0.501; chain_readings.py timing on an
//   NVIDIA H100 80GB HBM3 at 700 W; PERF.md).

#pragma once

#include "tensor_core.cuh"

namespace {
namespace cinfwd {

constexpr int kStages = 3;
constexpr int kBK = 64;             // padded z rows per ring stage
constexpr int kWStride = kBK + 8;   // bf16 per staged W row: 144 B, ldmatrix without conflicts

inline __host__ __device__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// bf16 per staged xk column: 32-bit B loads from 8 columns x 4 rows hit
// 32 banks when a staged column is 8 mod 64 bf16
inline __host__ __device__ int xk_stride(int hk8) { return round_up(hk8 - 8, 64) + 8; }

// bf16 per staged x0 column: 16-bit loads from 8 columns hit 8 banks when
// it is 2 mod 4
inline __host__ __device__ int x0_stride(int h0) {
  const int s = round_up(h0, 2);
  return s % 4 == 0 ? s + 2 : s;
}

// Copies rows [0, rows) of Wt (row stride kp), columns [c*kBK, c*kBK +
// kBK), into one ring stage; rows at or past `valid` read zeros.
__device__ __forceinline__ void load_w_slice(__nv_bfloat16* dst, const __nv_bfloat16* wt, int kp,
                                             int c, int rows, int valid, int tid, int nthreads) {
  for (int i = tid; i < rows * (kBK / 8); i += nthreads) {
    const int r = i >> 3, p = (i & 7) * 8;
    const bool on = r < valid;
    tc::cp_async16(dst + r * kWStride + p, wt + (size_t)(on ? r : 0) * kp + c * kBK + p,
                   on ? 16 : 0);
  }
}

// The B fragments of one k16 step, z rows [k0, k0+16) with (h_lo, m_lo)
// the field and row of k0: rows [k0, k0+8) are field h_lo, [k0+8, k0+16)
// the next 8 rows (field h_lo or h_lo + 1); past the last field they are
// zero. Advances (h_lo, m_lo) by 16 rows.
__device__ __forceinline__ void z_frags(uint32_t (&b)[4][2], const __nv_bfloat16* x0c, int x0st,
                                        const __nv_bfloat16* xkc, int xs, int h0, int hk8,
                                        int& h_lo, int& m_lo) {
  int h_hi = h_lo, m_hi = m_lo + 8;
  if (m_hi == hk8) {
    m_hi = 0;
    ++h_hi;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int off = j * 8;
    b[j][0] = h_lo < h0
        ? tc::mul_bf16x2(tc::dup_bf16(x0c[off * x0st + h_lo]),
                         *reinterpret_cast<const uint32_t*>(xkc + off * xs + m_lo))
        : 0u;
    b[j][1] = h_hi < h0
        ? tc::mul_bf16x2(tc::dup_bf16(x0c[off * x0st + h_hi]),
                         *reinterpret_cast<const uint32_t*>(xkc + off * xs + m_hi))
        : 0u;
  }
  h_lo = h_hi;
  m_lo = m_hi + 8;
  if (m_lo == hk8) {
    m_lo = 0;
    ++h_lo;
  }
}

// The k-loop over the padded z rows [0, kz) (kz = h0 * hk8). The caller
// has issued the first kStages - 1 slices (one commit group each, empty
// groups past the last slice); load_w(c) issues slice c into stage c %
// kStages. xkc and x0c point at this thread's first B column (row 2q of
// xk, row 0 of x0); map_row0 is the warp's first map in the ring's rows,
// mt the warp's m16 tiles that hold a map (warp-uniform; 0 skips the
// products). Every thread of the block calls it: it synchronises.
template <int kSplit, class LoadW>
__device__ __forceinline__ void z_product(float (&acc)[4][4][4], const __nv_bfloat16* ring,
                                          int stage_elems, LoadW&& load_w,
                                          const __nv_bfloat16* xkc, int xs,
                                          const __nv_bfloat16* x0c, int x0st, int h0, int hk8,
                                          int kz, int mt, int map_row0) {
  static_assert(kSplit == 0 || kSplit == 1 || kSplit == 2 || kSplit == 4,
                "k16 steps per fresh fragment: 0 (one accumulation), 1, 2 or 4");
  const int lane = threadIdx.x & 31;
  const int nchunks = (kz + kBK - 1) / kBK;
  const int nsteps = (kz + 15) / 16;
  // (field, row) of the first padded z row of the current k16 step
  int h_lo = 0, m_lo = 0;
  for (int c = 0; c < nchunks; ++c) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // slice c has landed; the stage slice c - 1 used is free
    if (c + kStages - 1 < nchunks) load_w(c + kStages - 1);
    tc::cp_async_commit();
    const __nv_bfloat16* ws = ring + (c % kStages) * stage_elems;
    const int steps = nsteps - c * 4 < 4 ? nsteps - c * 4 : 4;
    if constexpr (kSplit > 0) {
      if (mt == 0) continue;
#pragma unroll
      for (int ks0 = 0; ks0 < 4; ks0 += kSplit) {
        if (ks0 >= steps) break;
        uint32_t b[kSplit][4][2];
        z_frags(b[0], x0c, x0st, xkc, xs, h0, hk8, h_lo, m_lo);
#pragma unroll
        for (int kk = 1; kk < kSplit; ++kk)
          if (ks0 + kk < steps) z_frags(b[kk], x0c, x0st, xkc, xs, h0, hk8, h_lo, m_lo);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= mt) break;
          float part[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
#pragma unroll
          for (int kk = 0; kk < kSplit; ++kk) {
            if (kk > 0 && ks0 + kk >= steps) break;
            uint32_t af[4];
            tc::ldmatrix_x4(af, ws + (map_row0 + i * 16 + (lane & 15)) * kWStride +
                                    (ks0 + kk) * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < 4; ++j) tc::mma_bf16(part[j], af, b[kk][j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[j][e];
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= steps) break;
        uint32_t b[4][2];
        z_frags(b, x0c, x0st, xkc, xs, h0, hk8, h_lo, m_lo);
        // every A fragment first, then the products back to back
        uint32_t af[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < mt)
            tc::ldmatrix_x4(af[i], ws + (map_row0 + i * 16 + (lane & 15)) * kWStride + ks * 16 +
                                       (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < mt)
#pragma unroll
            for (int j = 0; j < 4; ++j) tc::mma_bf16(acc[i][j], af[i], b[j]);
      }
    }
  }
}

}  // namespace cinfwd
}  // namespace
