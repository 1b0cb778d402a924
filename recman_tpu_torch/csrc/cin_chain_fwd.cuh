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
// The feed rows stay in shared memory, as bf16, for the next layer.
//
// Bound on an H100 SXM: operations (cin_chain_fwd.cu gives the numbers),
// so the products run on the tensor cores: mma.sync.m16n8k16, bf16
// operands, f32 sums, through the k-loop K4 uses (cin_fwd_mma.cuh).
//
// Design:
// - A block owns 128 columns (B*D/128 blocks), or for D over 128 walks
//   the D/128 tiles of 128 columns of one batch row in turn (B blocks),
//   so that pooling over D stays inside the block: no cross-block
//   reduction and no atomics. It holds up to 256 maps of a layer at once:
//   4 warps of 32 columns for each group of 64 maps (16 warps at O 256, 8
//   at the bench's O 100), each warp 64 maps x 32 columns of f32 sums in
//   registers. A final layer of more maps (up to 512) runs in passes of
//   256: each pass walks W's ring again on the x0 and xk the block holds
//   and writes its maps' pooled sums and fmap rows once. A pass is one
//   product pre (maps x 128) = bf16(W)^T (maps x H0*Hk8) . z (H0*Hk8 x
//   128).
// - A: bf16(W) in K4's layout (the wrapper builds it once per call, Hk
//   padded to 8 with zeros), streamed through a 3-stage cp.async ring; W
//   is under 1.1 MB a layer, so it stays in L2 for all blocks.
// - B: z is built in registers from bf16 x0 and bf16 xk, both held in
//   shared memory column-major. x0 is staged once a tile; xk is x0 for
//   layer 0 and then the feed rows that each layer's epilogue writes back.
// - The epilogue works from the C fragments: bias and activation in
//   registers, the feed rows to shared memory as bf16 (the next layer's
//   xk; its padding rows zeroed), then each group of 64 maps staged as f32
//   in the ring's memory, from which a warp takes one map row of 128
//   columns at a time: the pooling (shuffles over the lanes of a batch
//   row; for D over 128 each tile's sum is added to the batch row's
//   pooled value by the same lane, in tile order), the saved fmap (16 B a
//   lane, coalesced), the sign bits (ballots).
// - The layers' descriptors (ChainLayer) sit in a table in device memory
//   that the launch writes on its stream, so the chain takes any number
//   of layers; the block copies the current one into shared memory.
// - Each sum has one owner and a fixed order: two calls are bit-equal.
//
// Geometry taken (the callers check and refuse outside it): the
// reference's chain (recman_tpu/ops/cin_chain.py:chain_supported): H0 and
// every Hk_i <= 128, O_i <= 512 (a non-final O_i even, so <= 256), D a
// power of two up to 1024 and B*D a multiple of max(128, D), any number
// of layers. Shared memory (chain_fwd_smem_bytes) is under 180 KB for all
// of them.

#pragma once

#include <vector>

#include "cin_fwd_mma.cuh"

namespace {

constexpr int kChainTileN = 128;                 // B*D columns per tile
constexpr int kChainOutStride = kChainTileN + 8; // f32 per staged fmap row
constexpr int kChainMaxGroups = 4;               // groups of 64 maps a pass
constexpr int kChainMaxThreads = 128 * kChainMaxGroups;  // 4 warps per group
constexpr int kChainSplit = 2;                   // k16 steps per fresh fragment (cin_fwd_mma.cuh)

// Up to kTableChunk entries of a table, passed by value to write_table.
constexpr int kTableChunk = 16;
template <class T>
struct TableChunk {
  T item[kTableChunk];
  int n;
};

template <class T>
__global__ void write_table(const TableChunk<T> c, T* dst) {
  if ((int)threadIdx.x < c.n) dst[threadIdx.x] = c.item[threadIdx.x];
}

// Writes the n entries of `host` into the device table `dev` on `st`,
// kTableChunk entries a launch: the launches copy their arguments, so the
// host array may go once this returns, and nothing waits on the stream.
template <class T>
cudaError_t upload_table(const T* host, int n, T* dev, cudaStream_t st) {
  for (int i = 0; i < n; i += kTableChunk) {
    TableChunk<T> c;
    c.n = n - i < kTableChunk ? n - i : kTableChunk;
    for (int k = 0; k < c.n; ++k) c.item[k] = host[i + k];
    write_table<T><<<1, 32, 0, st>>>(c, dev + i);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One layer of the chain, as the kernel reads it from its table.
struct ChainLayer {
  const __nv_bfloat16* wt;  // (o, kp) bf16: [o][h*hk8 + m] = bf16(W[h*hk+m, o])
  const float* b;           // (o,) f32
  float* out;               // (bd/d, o - feed) f32 (K1)
  float* fmap;              // (o, bd) f32 (K1), (feed, bd) f32 (rebuild), or null
  uint32_t* sign;           // (o, bd/128, 4) uint32 (rebuild)
  int hk8, o, kp, feed;
};

struct ChainArgs {
  const float* x0c;           // (h0, bd) f32
  const ChainLayer* layers;   // n_layers entries, device memory
  int h0, bd, d, n_layers, act;
  int groups;                 // groups of 64 maps a pass: the block has 4 warps each
  int xs, x0st;               // bf16 per staged column of xk and of x0
  int tiles;                  // 128-column tiles a block walks (D / 128 for D over 128, else 1)
};

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) return fmaxf(x, 0.0f);
  if (act == 2) return x >= 0.0f ? x : 0.2f * x;
  return x;
}

// Bytes of the ring, which the epilogue reuses for one group's f32 tile.
inline __host__ __device__ int chain_ring_bytes(int groups) {
  const int ring = cinfwd::kStages * groups * 64 * cinfwd::kWStride * 2;
  const int staged = 64 * kChainOutStride * 4;
  return ring > staged ? ring : staged;
}

// Bytes at the start of the kernel's shared memory for the current
// layer's descriptor, copied there from the table at the layer's start:
// at a fixed address, it takes no register.
constexpr int kChainLayerBytes = (sizeof(ChainLayer) + 15) / 16 * 16;

// kGeneral: a block walks several 128-column tiles (D over 128), or a
// layer has more maps than a pass holds. Without it the tile loop and the
// pass loop run once, and the compiler drops them: a pass loop it kept
// (its bound is not a constant) made K1 15% slower at the bench geometry
// (chain_readings.py timing on an NVIDIA H100 80GB HBM3, 700 W).
template <bool kRebuild, bool kGeneral>
__global__ void __launch_bounds__(kChainMaxThreads) cin_chain_fwd_kernel(const ChainArgs a) {
  using cinfwd::kStages;
  using cinfwd::kWStride;
  extern __shared__ __align__(16) unsigned char smem[];
  ChainLayer* const L = reinterpret_cast<ChainLayer*>(smem);  // the current layer
  unsigned char* const body = smem + kChainLayerBytes;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(body);  // kStages x groups*64 x kWStride
  float* outs = reinterpret_cast<float*>(body);                   // 64 x kChainOutStride, epilogue
  __nv_bfloat16* x0s =                                            // 128 x x0st: [n][h]
      reinterpret_cast<__nv_bfloat16*>(body + chain_ring_bytes(a.groups));
  __nv_bfloat16* xks = x0s + kChainTileN * a.x0st;                 // 128 x xs: [n][m]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int stage_elems = a.groups * 64 * kWStride;
  const int pass_maps = a.groups * 64;

  // the layer's descriptor from the table into shared memory, where every
  // thread reads it (the caller has synchronised since it was last read)
  auto stage_layer = [&](int l) {
    if (tid < (int)(sizeof(ChainLayer) / 8))
      reinterpret_cast<unsigned long long*>(L)[tid] =
          reinterpret_cast<const unsigned long long*>(a.layers + l)[tid];
    __syncthreads();
  };
  int map0 = 0;  // the first map of the current pass
  auto load_w = [&](int c) {
    const int o16 = cinfwd::round_up(L->o, 16) - map0;
    const int rows = o16 < pass_maps ? o16 : pass_maps;
    cinfwd::load_w_slice(ring + (c % kStages) * stage_elems,
                         L->wt + (size_t)map0 * L->kp, L->kp, c, rows, L->o - map0,
                         tid, nthreads);
  };
  auto prologue = [&]() {
    const int nchunks = (a.h0 * L->hk8 + cinfwd::kBK - 1) / cinfwd::kBK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nchunks) load_w(s);
      tc::cp_async_commit();
    }
  };

  const int tiles = kGeneral ? a.tiles : 1;
  for (int tile = 0; tile < tiles; ++tile) {
    const int col0 = (blockIdx.x * tiles + tile) * kChainTileN;
    const int row0 = col0 / a.d;                  // the batch row of the tile's first column
    stage_layer(0);
    map0 = 0;
    prologue();

    // bf16(x0) of the tile's columns, column-major, into x0s and (layer
    // 0's xk) into xks, whose padding rows [h0, hk8) are zero. Each thread
    // keeps 4 loads of 16 bytes in flight before it stores.
    const int quads = a.h0 * (kChainTileN / 4);
    for (int i0 = tid; i0 < quads; i0 += 4 * nthreads) {
      float4 v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * nthreads;
        v[e] = i < quads ? *reinterpret_cast<const float4*>(
                               a.x0c + (size_t)(i >> 5) * a.bd + col0 + (i & 31) * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * nthreads, h = i >> 5, n = (i & 31) * 4;
        if (i >= quads) break;
        const __nv_bfloat16 b4[4] = {__float2bfloat16_rn(v[e].x), __float2bfloat16_rn(v[e].y),
                                     __float2bfloat16_rn(v[e].z), __float2bfloat16_rn(v[e].w)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          x0s[(n + c) * a.x0st + h] = b4[c];
          xks[(n + c) * a.xs + h] = b4[c];
        }
      }
    }
    for (int i = tid; i < (L->hk8 - a.h0) * kChainTileN; i += nthreads)
      xks[(i % kChainTileN) * a.xs + a.h0 + i / kChainTileN] = __float2bfloat16_rn(0.0f);

    for (int l = 0; l < a.n_layers; ++l) {
      if (l > 0) stage_layer(l);
      const int o = L->o, hk8 = L->hk8, nfeed = L->feed;
      // passes of up to pass_maps maps; a layer that feeds the next has
      // at most 256 maps, so its feed rows come from its one pass
      for (map0 = 0; map0 < o; map0 += pass_maps) {
        // maps of this pass (in the fast kernel, the layer's)
        const int op = !kGeneral ? o : (o - map0 < pass_maps ? o - map0 : pass_maps);
        if (l > 0 || map0 > 0) prologue();  // layer 0's first slices went out before the staging

        float acc[4][4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
        // m16 tiles of this warp that hold a map of the pass (warp-uniform)
        int mt = (op - wm * 64 + 15) / 16;
        mt = mt < 0 ? 0 : (mt > 4 ? 4 : mt);
        cinfwd::z_product<kChainSplit>(acc, ring, stage_elems, load_w,
                                       xks + (wn * 32 + g) * a.xs + 2 * q, a.xs,
                                       x0s + (wn * 32 + g) * a.x0st, a.x0st, a.h0, hk8,
                                       a.h0 * hk8, mt, wm * 64);
        tc::cp_async_wait<0>();
        __syncthreads();  // every warp is done with xk and the ring

        // bias and activation on the fragments: acc[i][j][e] is map map0 +
        // wm*64 + 16i + g (+8 for e >= 2), column wn*32 + 8j + 2q + (e & 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= mt) break;
          const int o0 = map0 + wm * 64 + i * 16 + g, o1 = o0 + 8;
          const float b0 = o0 < o ? L->b[o0] : 0.0f, b1 = o1 < o ? L->b[o1] : 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j][0] = activate(acc[i][j][0] + b0, a.act);
            acc[i][j][1] = activate(acc[i][j][1] + b0, a.act);
            acc[i][j][2] = activate(acc[i][j][2] + b1, a.act);
            acc[i][j][3] = activate(acc[i][j][3] + b1, a.act);
          }
        }
        if (nfeed > 0) {
          // the feed rows, the next layer's xk: only bf16(xk) enters its z
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i >= mt) break;
            const int o0 = wm * 64 + i * 16 + g, o1 = o0 + 8;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = wn * 32 + j * 8 + 2 * q;
              if (o0 < nfeed) {
                xks[n * a.xs + o0] = __float2bfloat16_rn(acc[i][j][0]);
                xks[(n + 1) * a.xs + o0] = __float2bfloat16_rn(acc[i][j][1]);
              }
              if (o1 < nfeed) {
                xks[n * a.xs + o1] = __float2bfloat16_rn(acc[i][j][2]);
                xks[(n + 1) * a.xs + o1] = __float2bfloat16_rn(acc[i][j][3]);
              }
            }
          }
          const int pad = cinfwd::round_up(nfeed, 8) - nfeed;  // the next layer's padding rows
          for (int i = tid; i < pad * kChainTileN; i += nthreads)
            xks[(i % kChainTileN) * a.xs + nfeed + i / kChainTileN] = __float2bfloat16_rn(0.0f);
        }

        // each group of 64 maps through the staged f32 tile: a warp takes
        // one map row, lane l holding columns 4l..4l+3
        for (int grp = 0; grp * 64 < op; ++grp) {
          const int r_lo = map0 + grp * 64, r_hi = o < r_lo + 64 ? o : r_lo + 64;
          if (!kRebuild && L->fmap == nullptr && r_hi <= nfeed) continue;  // nothing to write
          if (wm == grp) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (i >= mt) break;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float* p = outs + (i * 16 + g) * kChainOutStride + wn * 32 + j * 8 + 2 * q;
                *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
                *reinterpret_cast<float2*>(p + 8 * kChainOutStride) =
                    make_float2(acc[i][j][2], acc[i][j][3]);
              }
            }
          }
          __syncthreads();
          for (int r = warp; r < r_hi - r_lo; r += nwarps) {
            const int om = r_lo + r;
            const int n0 = lane * 4;
            const float4 v4 = *reinterpret_cast<const float4*>(outs + r * kChainOutStride + n0);
            const float v[4] = {v4.x, v4.y, v4.z, v4.w};
            if constexpr (kRebuild) {
              uint4 s;
              s.x = __ballot_sync(0xffffffffu, v[0] > 0.0f);
              s.y = __ballot_sync(0xffffffffu, v[1] > 0.0f);
              s.z = __ballot_sync(0xffffffffu, v[2] > 0.0f);
              s.w = __ballot_sync(0xffffffffu, v[3] > 0.0f);
              if (lane == 0)
                reinterpret_cast<uint4*>(L->sign)[(size_t)om * (a.bd / kChainTileN) +
                                                 col0 / kChainTileN] = s;
            }
            if (L->fmap != nullptr && (!kRebuild || om < nfeed))
              *reinterpret_cast<float4*>(L->fmap + (size_t)om * a.bd + col0 + n0) = v4;
            if (kRebuild || om < nfeed) continue;
            const int nout = o - nfeed;
            float* dst = L->out + (om - nfeed);
            if (a.d >= 4) {
              float s = (v[0] + v[1]) + (v[2] + v[3]);
              const int lanes = a.d < 128 ? a.d / 4 : 32;  // lanes per batch row
              for (int off = 1; off < lanes; off <<= 1)
                s += __shfl_xor_sync(0xffffffffu, s, off);
              if ((lane & (lanes - 1)) == 0) {
                float* p = dst + (size_t)(row0 + n0 / a.d) * nout;
                // D over 128: the row's later tiles add to its first one's sum
                *p = kGeneral && col0 % a.d != 0 ? *p + s : s;
              }
            } else {
              for (int c = 0; c < 4; c += a.d) {
                float s = 0.0f;
                for (int e = 0; e < a.d; ++e) s += v[c + e];
                dst[(size_t)(row0 + (n0 + c) / a.d) * nout] = s;
              }
            }
          }
          __syncthreads();  // the tile is free for the next group, the ring for the next pass
        }
        if constexpr (!kGeneral) break;  // one pass: the compiler keeps no loop
      }
    }
  }
}

// The kernel's block for a geometry: groups of 64 maps (4 warps each)
// a pass, the bf16 strides of the staged x0 and xk columns, and the
// shared memory in bytes.
struct ChainFwdPlan {
  int groups, xs, x0st, smem;
  bool wide;  // a layer has more maps than a pass holds
};

inline ChainFwdPlan chain_fwd_plan(int h0, int n_layers, const int* units) {
  int hk = h0, max_hk8 = 0, max_o16 = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int hk8 = cinfwd::round_up(hk, 8), o16 = cinfwd::round_up(units[l], 16);
    if (hk8 > max_hk8) max_hk8 = hk8;
    if (o16 > max_o16) max_o16 = o16;
    hk = units[l] / 2;
  }
  ChainFwdPlan p;
  p.groups = (max_o16 + 63) / 64;
  if (p.groups > kChainMaxGroups) p.groups = kChainMaxGroups;
  p.xs = cinfwd::xk_stride(max_hk8);
  p.x0st = cinfwd::x0_stride(h0);
  p.smem = kChainLayerBytes + chain_ring_bytes(p.groups) + kChainTileN * (p.x0st + p.xs) * 2;
  p.wide = max_o16 > p.groups * 64;
  return p;
}

// Shared memory the kernel needs for a geometry, in bytes.
inline int chain_fwd_smem_bytes(int h0, int n_layers, const int* units) {
  return chain_fwd_plan(h0, n_layers, units).smem;
}

// Whether the kernels take (h0, units, d, bd): the reference chain's
// geometry (see the top).
inline bool chain_geometry_ok(int h0, int bd, int d, int n_layers, const int* units) {
  if (n_layers < 1 || h0 < 1 || h0 > 128 || d < 1 || d > 1024 || (d & (d - 1)) != 0 ||
      bd < 1 || bd % (d > kChainTileN ? d : kChainTileN) != 0)
    return false;
  int hk = h0;
  for (int l = 0; l < n_layers; ++l) {
    const int o = units[l];
    const bool final_layer = l == n_layers - 1;
    if (o < 1 || o > 512 || hk > 128 || (!final_layer && (o % 2 != 0 || o / 2 > 128)))
      return false;
    hk = o / 2;
  }
  return true;
}

// Bytes of the layer table a launch of chain_fwd_launch writes.
inline int chain_fwd_table_bytes(int n_layers) { return n_layers * (int)sizeof(ChainLayer); }

// Launches the kernel on `stream`. x0c (h0, bd) f32; w[l] (units[l],
// kp_l) bf16 in K4's layout, w[l][o][h*hk8_l + m] = bf16(W_l[h*hk_l + m,
// o]) with hk8_l = roundup8(hk_l), kp_l = roundup64(h0 * hk8_l) and
// padding zero; b[l] (units[l],) f32. K1 (sign null): out[l] (bd/d, F_l)
// f32, and fmap null or fmap[l] (units[l], bd) f32. The rebuild (sign
// given, out null): fmap[l] (units[l]/2, bd) f32 for each non-final layer
// (null for the last) and sign[l] (units[l], bd/128, 4) uint32. act: 0
// identity, 1 relu, 2 leaky_relu. table: chain_fwd_table_bytes(n_layers)
// bytes of device memory, 8-byte aligned, for the layers' descriptors.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for a geometry outside the range).
inline int chain_fwd_launch(const void* x0c, int h0, int bd, int d, int n_layers,
                            const int* units, const void* const* w, const void* const* b,
                            void* const* out, void* const* fmap, void* const* sign, int act,
                            void* table, cudaStream_t stream) {
  if (!chain_geometry_ok(h0, bd, d, n_layers, units) || act < 0 || act > 2 || table == nullptr)
    return (int)cudaErrorInvalidValue;
  std::vector<ChainLayer> layers(n_layers);
  ChainArgs a;
  int hk = h0;
  for (int l = 0; l < n_layers; ++l) {
    ChainLayer& c = layers[l];
    const int o = units[l];
    c.hk8 = cinfwd::round_up(hk, 8);
    c.kp = cinfwd::round_up(h0 * c.hk8, cinfwd::kBK);
    c.o = o;
    c.feed = l == n_layers - 1 ? 0 : o / 2;
    c.wt = static_cast<const __nv_bfloat16*>(w[l]);
    c.b = static_cast<const float*>(b[l]);
    c.out = out != nullptr ? static_cast<float*>(out[l]) : nullptr;
    c.fmap = fmap != nullptr ? static_cast<float*>(fmap[l]) : nullptr;
    c.sign = sign != nullptr ? static_cast<uint32_t*>(sign[l]) : nullptr;
    hk = o / 2;
  }
  const ChainFwdPlan plan = chain_fwd_plan(h0, n_layers, units);
  a.tiles = d > kChainTileN ? d / kChainTileN : 1;
  const bool general = plan.wide || a.tiles > 1;
  a.layers = static_cast<ChainLayer*>(table);
  cudaError_t err = upload_table(layers.data(), n_layers, static_cast<ChainLayer*>(table), stream);
  if (err != cudaSuccess) return (int)err;
  a.x0c = static_cast<const float*>(x0c);
  a.h0 = h0;
  a.bd = bd;
  a.d = d;
  a.n_layers = n_layers;
  a.act = act;
  a.groups = plan.groups;
  a.xs = plan.xs;
  a.x0st = plan.x0st;
  const bool rebuild = sign != nullptr;
  auto kernel = rebuild ? (general ? cin_chain_fwd_kernel<true, true>
                                   : cin_chain_fwd_kernel<true, false>)
                        : (general ? cin_chain_fwd_kernel<false, true>
                                   : cin_chain_fwd_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bd / (kChainTileN * a.tiles), 128 * plan.groups, plan.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
