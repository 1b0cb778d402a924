// K2: the whole CIN tower backward, from the pooled cotangents and either
// the fmaps that K1 saved (the save form, cin_chain_bwd) or fmaps rebuilt
// from x0c, W and b (the recompute form, cin_chain_bwd_recompute), on the
// tensor cores.
//
// Replaces the TPU kernel recman_tpu/ops/cin_chain.py:_chain_bwd_kernel
// in both its forms (launched from _chain_bwd_pallas with fmaps, and
// without them under CHAIN_SAVE_FMAPS = False). Bound to PyTorch through a
// plain C interface (ctypes); the wrappers are
// recman_tpu_torch/ops/cin_chain.py:cin_chain_bwd and
// cin_chain_bwd_recompute.
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
// makes, at the same place. Of the fmaps the backward reads only two
// things: act' of every fmap element (from its sign, fmap > 0) and the
// feed rows (the xk of the next layer).
//
// Bound on an H100 SXM: operations. At the training geometry (H0 = 26,
// units (100, 100), D = 16, B = 8192) dW and u each take 51.8 GFLOP of
// bf16 products, 103.6 GFLOP in all: 0.105 ms at the 989 TFLOP/s bf16
// tensor-core peak. The bytes (the fmaps 104.9 MB, x0c and dx0 13.6 MB
// each, the pooled cotangents 4.9 MB) take 0.041 ms at 3.35 TB/s. So both
// products run on the tensor cores: mma.sync.m16n8k16, bf16 operands, f32
// sums. Padding (Hk 26 -> 32 and 50 -> 56, O 100 -> 112) makes them do
// about 1.3x the function's products.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W
// (recman_tpu_torch/tools/chain_readings.py): with the split sums of
// cin_bwd_mma.cuh 1.458-1.461 ms at that geometry (71 TFLOP/s) and 10.90
// ms at B = 65,536, the recompute form 1.844-1.854 and 13.78-13.79 ms;
// with one accumulation 1.29-1.31, 9.58, 1.68 and 12.49 ms; the
// CUDA-core design this replaces 4.56, 35.60 and 48.73 ms. At 65,536 phase 1 takes 6.65 ms of
// it and the two dW contractions 2.76 ms (a chip_smoke.py profile); the
// bare bf16 contractions (torch.matmul on prebuilt operands) take 5.81
// ms. Phase 1 runs one block of 16 warps an SM with a few products a
// field between barriers: neither a deeper W ring nor loading its gpre
// rows or x0 earlier made it faster; what holds it is an open question
// (PERF.md). The dW phase reads x0c and the f32 feed rows, not bf16
// copies of them: copies would save 0.13-0.18 ms at 65,536 and add 159
// MB to the call's peak.
//
// Design. The TPU kernel carries dW and db in VMEM across its sequential
// grid. Blocks on the card run in no order, so the work splits in three
// phases, with no atomics, each sum in a fixed order: two calls are
// bit-equal.
// 1. cin_chain_bwd_cols: everything except dW is local to a column, so a
//    block owns 128 columns (it reads g at each column's batch row) and walks
//    the layers in reverse with K5's 16 warps (cin_bwd_mma.cuh). Per
//    layer it forms gpre on the CUDA cores (a warp per map row: the
//    cotangent, act' from the fmap or its bit), writes its partial db per
//    map, and keeps bf16(gpre) (O16 x 128) in shared memory and in device
//    memory (O, B*D) for phase 2. Then, per field h, u_h = W_h (Hk8 x
//    O16) . gpre (O16 x 128) on the tensor cores, through K5's field loop: W in K5's layout
//    (Hk padded to 8) streams through a cp.async ring, gpre comes through
//    ldmatrix.trans, and u is folded from the accumulator fragments into
//    dx0[h] (kept in shared memory, f32, across the layers) and dxk
//    (registers, across the fields), with x0 and xk in f32. dxk goes down
//    to the layer below through shared memory (the ring's), or onto dx0 at
//    layer 0.
// 2. The dW contraction of K5 (cin_bwd_mma.cuh: cin_bwd_dw), once per
//    layer: dW_i = z_i . bf16(gpre_i)^T over the columns in splits, z built
//    in registers from x0c and the layer's f32 xk rows (the saved fmap's
//    or phase 0's feed rows), which each block rounds to bf16 a slice at a
//    time, a partial dW per split.
// 3. cin_chain_bwd_reduce: dW = the sum of the split partials and db the
//    sum of the block partials, both in index order.
//
// The recompute form (the reference's CHAIN_SAVE_FMAPS = False: no fmap
// crosses from the forward to the backward, whose activation memory is
// then O(B*D*H0) instead of O(B*D*sum O_i)). A phase 0 runs K1's own
// kernel (cin_chain_fwd.cuh) again, the same arithmetic in the same
// order, so the rebuilt values are the bits K1 saves; it writes, into
// scratch that lives only for the backward, the two things phases 1 and 2
// read of the fmaps: each non-final layer's feed rows in f32 (phases 1
// and 2 take xk in f32) and one bit per fmap element (fmap > 0, which
// gives act'). Phases 1-3 then run as in the
// save form, reading the feed scratch where they read fmap rows and the
// bits where they read the fmap for act', so both forms give the same
// bits. Scratch at the training geometry (units (100, 100), B*D =
// 1,048,576, batch 65,536): feed rows 50 x B*D x 4 B = 209.7 MB and bits
// 200 x B*D / 8 = 26.2 MB, against the save form's 838.9 MB of fmaps kept
// from the forward to the backward.
// Bound on an H100 SXM: operations, the forward's and the backward's:
// 155.4 GFLOP at B = 8192, 0.157 ms at 989 TFLOP/s.
//
// Phase 1 holds bf16(gpre) of up to 256 maps of a layer: a final layer
// of more (up to 512) runs in passes of 256 maps, each folding its share
// of u into dx0 and dxk. The layers' descriptors sit in tables in device
// memory that the launch writes on its stream (cin_chain_fwd.cuh:
// upload_table), so the chain takes any number of layers.
//
// Geometry taken (the wrapper checks and raises outside it): K1's, the
// reference chain's range (cin_chain_fwd.cuh: chain_geometry_ok). Phase
// 1 then fits in a block's 227 KB of shared memory: its fixed part is at
// most 134 KB, and the W ring narrows to a slice of 64 maps (54 KB at Hk
// 128) where a wider one does not fit.

#include "cin_bwd_mma.cuh"
#include "cin_chain_fwd.cuh"

namespace {

using cinbwd::kCols;
using cinbwd::kColsThreads;
using cinbwd::kGStride;
using cinbwd::kMaxSmem;
using cinbwd::kSlice;
using cinbwd::round_up;

constexpr int kPassMaps = 256;  // maps of a layer phase 1 holds at once (bf16(gpre) in gs)

// One layer of phase 1, as the kernel reads it from its table.
struct ColsLayer {
  const __nv_bfloat16* wp;  // (h0*hk8, o64) bf16: [h*hk8 + m][o] = bf16(W[h*hk+m, o])
  const float* fmap;        // (o, bd) f32 saved fmap, or null: read sign
  const uint32_t* sign;     // (o, bd/128, 4) uint32 bits fmap > 0
  const float* xk;          // (>= hk, bd) f32 rows of layer l's xk (x0c for l = 0)
  const float* g;           // (bd/d, o - feed) f32
  __nv_bfloat16* gb;        // (o, bd) bf16 scratch: bf16(gpre)
  int hk, hk8, o, o64, sw, feed, db_off;
};

struct ColsArgs {
  const float* x0c;          // (h0, bd) f32
  const ColsLayer* layers;   // n_layers entries, device memory
  float* pdb;                // (bd/128, o_total) f32
  float* dx0;                // (h0, bd) f32
  int h0, bd, d, n_layers, act, o_total;
  int pass_maps;             // maps a pass holds: O rounded up to 16, at most kPassMaps
};

// d act / d pre from the sign of the activation's output (fmap > 0 <=>
// pre > 0 for the supported set), as the reference reads it
__device__ __forceinline__ float act_deriv(bool positive, int act) {
  if (act == 1) return positive ? 1.0f : 0.0f;
  if (act == 2) return positive ? 1.0f : 0.2f;
  return 1.0f;
}

// Phase 1's shared memory before the ring: dx0 (h0 x 128 f32), the dx0
// partials (4 x 128 f32) and bf16(gpre) of a pass (pass_maps x kGStride
// bf16).
int cols_fixed_bytes(int h0, int pass_maps) {
  return h0 * kCols * 4 + 4 * kCols * 4 + pass_maps * kGStride * 2;
}

// NTW: n8 tiles of u a warp holds, at least half of the widest hk8 / 8
template <int NTW>
__global__ void __launch_bounds__(kColsThreads, 1) cin_chain_bwd_cols(const ColsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dx0s = reinterpret_cast<float*>(smem);                 // h0 x 128
  float* red = dx0s + a.h0 * kCols;                             // 2 x 2 x 128: dx0 halves
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(red + 4 * kCols);  // pass_maps x kGStride
  unsigned char* tail = reinterpret_cast<unsigned char*>(gs + a.pass_maps * kGStride);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(tail);  // the field loop's W ring
  float* dxks = reinterpret_cast<float*>(tail);                  // hk x 128: dxk handed down

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = lane * 4;
  const int col0 = blockIdx.x * kCols;
  const int row0 = col0 / a.d;  // the batch row of the block's first column

  for (int i = tid; i < a.h0 * kCols; i += kColsThreads) dx0s[i] = 0.0f;

  for (int l = a.n_layers - 1; l >= 0; --l) {
    // the layer's descriptor, read where it is used (not held in registers)
    const ColsLayer* L = a.layers + l;
    const int hk = L->hk, hk8 = L->hk8, o = L->o, feed = L->feed;
    const int nd = o - feed;
    const cinbwd::ColsThread t = cinbwd::cols_thread(hk8, a.bd);
    float xkr[NTW][4], dxk[NTW][4];
    // passes of up to pass_maps maps; a layer that feeds the next has at
    // most 256 maps, so the feed rows' cotangent (dxks) is read in its one
    // pass. Every pass folds into dx0s and dxk.
    for (int map0 = 0; map0 < o; map0 += a.pass_maps) {
      const int op = o - map0 < a.pass_maps ? o - map0 : a.pass_maps;
      const int o16 = round_up(op, 16);
      __syncthreads();  // dxks holds layer l+1's dxk; gs and the ring are free

      // gpre, its bf16 rounding and this block's partial db, one map per
      // warp; rows [op, o16) of gs are zero
      for (int r = warp; r < o16; r += kColsThreads / 32) {
        uint2* gdst = reinterpret_cast<uint2*>(gs + r * kGStride + n0);
        if (r >= op) {
          *gdst = make_uint2(0u, 0u);
          continue;
        }
        const int om = map0 + r;
        bool pos[4];
        if (L->fmap != nullptr) {
          const float4 f =
              *reinterpret_cast<const float4*>(L->fmap + (size_t)om * a.bd + col0 + n0);
          pos[0] = f.x > 0.0f, pos[1] = f.y > 0.0f, pos[2] = f.z > 0.0f, pos[3] = f.w > 0.0f;
        } else {
          const uint4 s = reinterpret_cast<const uint4*>(L->sign)[
              (size_t)om * (a.bd / kCols) + blockIdx.x];
          pos[0] = (s.x >> lane) & 1u, pos[1] = (s.y >> lane) & 1u;
          pos[2] = (s.z >> lane) & 1u, pos[3] = (s.w >> lane) & 1u;
        }
        float gp[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float df = om < feed
              ? dxks[om * kCols + n0 + c]
              : L->g[(size_t)(row0 + (n0 + c) / a.d) * nd + (om - feed)];
          gp[c] = a.act == 0 ? df : df * act_deriv(pos[c], a.act);
        }
        float s = (gp[0] + gp[1]) + (gp[2] + gp[3]);
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) a.pdb[(size_t)blockIdx.x * a.o_total + L->db_off + om] = s;
        const uint2 b = tc::pack_bf16x4(make_float4(gp[0], gp[1], gp[2], gp[3]));
        *gdst = b;
        *reinterpret_cast<uint2*>(L->gb + (size_t)om * a.bd + col0 + n0) = b;
      }
      if (map0 == 0) {
        // this thread's xk, f32, in the fragment layout of its dxk
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int m = 8 * (t.j0 + j) + 2 * t.q;
          const bool on = j < t.ntw;
          xkr[j][0] = on && m < hk ? L->xk[(size_t)m * a.bd + t.ca] : 0.0f;
          xkr[j][1] = on && m + 1 < hk ? L->xk[(size_t)(m + 1) * a.bd + t.ca] : 0.0f;
          xkr[j][2] = on && m < hk ? L->xk[(size_t)m * a.bd + t.cb] : 0.0f;
          xkr[j][3] = on && m + 1 < hk ? L->xk[(size_t)(m + 1) * a.bd + t.cb] : 0.0f;
          dxk[j][0] = dxk[j][1] = dxk[j][2] = dxk[j][3] = 0.0f;
        }
      }
      __syncthreads();  // gs is complete and dxks consumed: the ring may overwrite it

      const cinbwd::WRing w(ring, L->wp + map0, a.h0, hk8, o16, L->o64, L->sw);
      w.prologue();
      cinbwd::fold_fields<NTW>(w, gs, red, a.x0c, a.bd, a.h0, xkr, dxk, [&](int h) {
        if (t.half != 0 || t.q != 0) return;
        const float2 s = cinbwd::dx0_partials(red, h, t);
        dx0s[h * kCols + t.wc + t.g] += s.x;
        dx0s[h * kCols + t.wc + t.g + 8] += s.y;
      });
    }

    // dxk down to layer l-1's gpre (into the ring's memory, free now), or
    // at layer 0 onto dx0, after the last field's partials are in
    if (l == 0) __syncthreads();
    const int na = t.wc + t.g, nb = na + 8;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int m = 8 * (t.j0 + j) + 2 * t.q;
      if (j >= t.ntw) break;
      if (l > 0) {
        if (m < hk) dxks[m * kCols + na] = dxk[j][0], dxks[m * kCols + nb] = dxk[j][2];
        if (m + 1 < hk) dxks[(m + 1) * kCols + na] = dxk[j][1], dxks[(m + 1) * kCols + nb] = dxk[j][3];
      } else {
        if (m < hk) dx0s[m * kCols + na] += dxk[j][0], dx0s[m * kCols + nb] += dxk[j][2];
        if (m + 1 < hk) dx0s[(m + 1) * kCols + na] += dxk[j][1], dx0s[(m + 1) * kCols + nb] += dxk[j][3];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < a.h0 * (kCols / 4); i += kColsThreads) {
    const int h = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
    *reinterpret_cast<float4*>(a.dx0 + (size_t)h * a.bd + col0 + c) =
        *reinterpret_cast<const float4*>(dx0s + h * kCols + c);
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

// Phase 1's block for a geometry: the maps of a pass, the W slice of each
// layer's ring (the widest multiple of 64 maps that fits), the n8 tiles a
// warp holds, and the shared memory in bytes (at most kMaxSmem anywhere
// in the range).
struct ColsPlan {
  int pass_maps, ntw, smem;
  std::vector<int> sw;
};

ColsPlan cols_plan(int h0, int n_layers, const int* units) {
  ColsPlan p;
  p.pass_maps = p.ntw = 0;
  p.sw.resize(n_layers);
  int hk = h0, dxks = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int o16 = round_up(units[l] < kPassMaps ? units[l] : kPassMaps, 16);
    if (o16 > p.pass_maps) p.pass_maps = o16;
    const int ntw = (round_up(hk, 8) / 8 + 1) / 2;
    if (ntw > p.ntw) p.ntw = ntw;
    if (l > 0 && hk * kCols * 4 > dxks) dxks = hk * kCols * 4;
    hk = units[l] / 2;
  }
  const int fixed = cols_fixed_bytes(h0, p.pass_maps);
  int tail = dxks;
  hk = h0;
  for (int l = 0; l < n_layers; ++l) {
    const int hk8 = round_up(hk, 8);
    int sw = round_up(units[l] < kPassMaps ? units[l] : kPassMaps, kSlice);
    while (sw > kSlice && fixed + cinbwd::ring_bytes(hk8, sw) > kMaxSmem) sw -= kSlice;
    p.sw[l] = sw;
    if (cinbwd::ring_bytes(hk8, sw) > tail) tail = cinbwd::ring_bytes(hk8, sw);
    hk = units[l] / 2;
  }
  p.smem = fixed + tail;
  return p;
}

template <int NTW>
cudaError_t launch_cols(const ColsArgs& a, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(cin_chain_bwd_cols<NTW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cin_chain_bwd_cols<NTW><<<a.bd / kCols, kColsThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// Bytes of phase 1's layer table, 8-byte aligned.
int cols_table_bytes(int n_layers) { return round_up(n_layers * (int)sizeof(ColsLayer), 8); }

}  // namespace

// K2's launch plan for a geometry of the chain's range: fills splits[l],
// the column splits of layer l's dW phase (the wrapper sizes its
// partial-dW scratch by them), for a card with `sms` SMs, and returns the
// shared memory of a phase-1 block in bytes.
extern "C" int cin_chain_bwd_plan(int h0, int bd, int n_layers, const int* units, int sms,
                                  int* splits) {
  int hk = h0;
  for (int l = 0; l < n_layers; ++l) {
    splits[l] = cinbwd::dw_splits(h0 * hk, units[l], bd, sms);
    hk = units[l] / 2;
  }
  return cols_plan(h0, n_layers, units).smem;
}

// Bytes of device memory either form needs for its tables of layers
// (phase 1's, then the recompute form's phase 0's).
extern "C" int cin_chain_bwd_table_bytes(int n_layers) {
  return cols_table_bytes(n_layers) + chain_fwd_table_bytes(n_layers);
}

namespace {

// Phases 1-3 of either form on `stream`. fmap[l] (units[l], bd) f32 saved
// fmaps, or null and then sign[l] (units[l], bd/128, 4) uint32 bits fmap >
// 0; xk[l] for l >= 1: (>= hk_l, bd) f32 rows holding layer l's xk (the
// saved fmap_{l-1}, or the feed rows of the recompute form's phase 0);
// table: cols_table_bytes(n_layers) bytes of device memory.
int bwd_launch(const void* x0c, int h0, int bd, int d, int n_layers, const int* units,
               const void* const* wp, const void* const* fmap, const void* const* sign,
               const void* const* xk, const void* const* g, void* const* gb, void* pdb,
               void* const* pdw, const int* splits, void* dx0, void* const* dw,
               void* const* db, int act, void* table, cudaStream_t st) {
  if (!chain_geometry_ok(h0, bd, d, n_layers, units) || act < 0 || act > 2 || table == nullptr)
    return (int)cudaErrorInvalidValue;
  const ColsPlan plan = cols_plan(h0, n_layers, units);
  if (plan.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  std::vector<ColsLayer> layers(n_layers);
  int o_total = 0, hk = h0;
  for (int l = 0; l < n_layers; ++l) {
    ColsLayer& c = layers[l];
    const int o = units[l];
    if (splits[l] < 1) return (int)cudaErrorInvalidValue;
    c.hk = hk;
    c.hk8 = round_up(hk, 8);
    c.o = o;
    c.o64 = round_up(o, kSlice);
    c.sw = plan.sw[l];
    c.feed = l == n_layers - 1 ? 0 : o / 2;
    c.db_off = o_total;
    o_total += o;
    c.wp = static_cast<const __nv_bfloat16*>(wp[l]);
    c.fmap = fmap != nullptr ? static_cast<const float*>(fmap[l]) : nullptr;
    c.sign = sign != nullptr ? static_cast<const uint32_t*>(sign[l]) : nullptr;
    if (c.fmap == nullptr && c.sign == nullptr) return (int)cudaErrorInvalidValue;
    c.xk = l == 0 ? static_cast<const float*>(x0c) : static_cast<const float*>(xk[l]);
    c.g = static_cast<const float*>(g[l]);
    c.gb = static_cast<__nv_bfloat16*>(gb[l]);
    hk = o / 2;
  }
  ColsLayer* dev = static_cast<ColsLayer*>(table);
  cudaError_t err = upload_table(layers.data(), n_layers, dev, st);
  if (err != cudaSuccess) return (int)err;
  ColsArgs a;
  a.x0c = static_cast<const float*>(x0c);
  a.layers = dev;
  a.pdb = static_cast<float*>(pdb);
  a.dx0 = static_cast<float*>(dx0);
  a.h0 = h0;
  a.bd = bd;
  a.d = d;
  a.n_layers = n_layers;
  a.act = act;
  a.o_total = o_total;
  a.pass_maps = plan.pass_maps;
  err = plan.ntw <= 2 ? launch_cols<2>(a, plan.smem, st)
      : plan.ntw <= 4 ? launch_cols<4>(a, plan.smem, st)
                      : launch_cols<8>(a, plan.smem, st);
  if (err != cudaSuccess) return (int)err;

  const int blocks = bd / kCols;
  for (int l = 0; l < n_layers; ++l) {
    const ColsLayer& c = layers[l];
    float* pdw_l = static_cast<float*>(pdw[l]);
    err = cinbwd::dw_launch(a.x0c, c.xk, c.gb, pdw_l, h0, c.hk, c.o, bd, splits[l], st);
    if (err != cudaSuccess) return (int)err;
    const int n_dw = h0 * c.hk * c.o;
    cin_chain_bwd_reduce<<<(n_dw + c.o + 255) / 256, 256, 0, st>>>(
        pdw_l, splits[l], n_dw, static_cast<float*>(dw[l]), a.pdb, blocks, o_total, c.db_off,
        c.o, static_cast<float*>(db[l]));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K2's save form on `stream`: phase 1 once, then phase 2 and the
// reduction once per layer. x0c (h0, bd) f32; wp[l] (h0*hk8_l,
// roundup64(units[l])) bf16 in K5's layout, wp[l][h*hk8_l + m][o] =
// bf16(W_l[h*hk_l + m, o]) with hk8_l = roundup8(hk_l) and padding 0;
// fmap[l] (units[l], bd) f32 from K1; g[l] (bd/d, F_l) f32 pooled
// cotangents. Scratch: gb[l] (units[l], bd) bf16; pdb (bd/128, sum
// units) f32; pdw[l] (splits[l], h0*hk_l, units[l]) f32; table
// cin_chain_bwd_table_bytes(n_layers) bytes. Out: dx0 (h0, bd), dw[l]
// (h0*hk_l, units[l]), db[l] (units[l],), all f32. act: 0 identity, 1
// relu, 2 leaky_relu.
// Returns cudaGetLastError() after the launches (or cudaErrorInvalidValue
// for a geometry outside the kernel's range).
extern "C" int cin_chain_bwd(const void* x0c, int h0, int bd, int d, int n_layers,
                             const int* units, const void* const* wp,
                             const void* const* fmap, const void* const* g,
                             void* const* gb, void* pdb, void* const* pdw,
                             const int* splits, void* dx0, void* const* dw,
                             void* const* db, int act, void* table, void* stream) {
  if (n_layers < 1) return (int)cudaErrorInvalidValue;
  std::vector<const void*> xk(n_layers, nullptr);
  for (int l = 1; l < n_layers; ++l) xk[l] = fmap[l - 1];
  return bwd_launch(x0c, h0, bd, d, n_layers, units, wp, fmap, nullptr, xk.data(), g, gb, pdb,
                    pdw, splits, dx0, dw, db, act, table, static_cast<cudaStream_t>(stream));
}

// Launches K2's recompute form on `stream`: phase 0 (K1's kernel, from x0c,
// w and b, writing the feed rows and the sign bits), then phases 1-3 as
// the save form. w[l] in K1's layout and b[l] (units[l],) f32 as K1 takes
// them; wp, g, gb, pdb, pdw, splits, table and the outputs as
// cin_chain_bwd. Scratch of phase 0: feed[l] for every non-final layer
// (units[l]/2, bd) f32 (feed[n_layers-1] unused); sign[l] (units[l],
// bd/128, 4) uint32. Returns as cin_chain_bwd.
extern "C" int cin_chain_bwd_recompute(const void* x0c, int h0, int bd, int d, int n_layers,
                                       const int* units, const void* const* w,
                                       const void* const* b, const void* const* wp,
                                       void* const* feed, void* const* sign,
                                       const void* const* g, void* const* gb, void* pdb,
                                       void* const* pdw, const int* splits, void* dx0,
                                       void* const* dw, void* const* db, int act, void* table,
                                       void* stream) {
  if (n_layers < 1 || table == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  std::vector<void*> fmap(n_layers, nullptr);
  std::vector<const void*> xk(n_layers, nullptr);
  for (int l = 0; l + 1 < n_layers; ++l) {
    fmap[l] = feed[l];
    xk[l + 1] = feed[l];
  }
  void* fwd_table = static_cast<unsigned char*>(table) + cols_table_bytes(n_layers);
  const int err = chain_fwd_launch(x0c, h0, bd, d, n_layers, units, w, b, nullptr, fmap.data(),
                                   sign, act, fwd_table, st);
  if (err != 0) return err;
  return bwd_launch(x0c, h0, bd, d, n_layers, units, wp, nullptr, sign, xk.data(), g, gb, pdb,
                    pdw, splits, dx0, dw, db, act, table, st);
}
