// K3: the batched segment sum of the stacked embedding backward; K7, its
// form with row-major table output (the two share every pass below); and
// K6, the one-table form with row-major input and output, which runs their
// sums and fix-up in one launch (after K7).
//
// K3 replaces the TPU kernel
// recman_tpu/ops/embedding.py:_segment_matmul_from_sorted_batched (reached
// through _segmat_batched_segmented from _stacked_gather_split_bwd). Bound
// to PyTorch through a plain C interface (ctypes); the wrapper is
// recman_tpu_torch/ops/segment_matmul.py:segment_matmul_from_sorted_batched.
//
// What it computes: sorted ids (T, N) int32 and the cotangents permuted
// into that order, transposed, (T, C, N) f32, give dense grads (T, C, V)
// f32: out[t, c, v] is the f32 sum of sg[t, c, p] over the positions p
// with sids[t, p] == v. Every column is written, 0 where no id falls; ids
// outside [0, V) land nowhere. The TPU kernel builds one-hot masks and
// contracts them on its matrix unit; here the ids are sorted, so equal ids
// form one contiguous run and each run's sum lands in exactly one column.
//
// Bound on an H100 SXM: bytes. At the training geometry (T = 26, C = 17,
// N = 8192, V = 100,001) it reads the ids (0.85 MB) and the cotangents
// (14.5 MB) and writes the grads (176.8 MB): 192.1 MB, 0.0574 ms at
// 3.35 TB/s; at the large-batch step's N = 65,536, 299.5 MB, 0.0894 ms.
// The 3.6 MFLOP of adds are nothing. The zeros are 92% of the bytes.
//
// Design (deterministic, no atomics): four launches on one stream, each
// after the first a programmatic dependent of the one before it, with a
// scratch that the wrapper allocates (segment_matmul_scratch_floats).
// 1. map_clear: zeros over the (T, V) map from ids to records.
// 2. segment_sums: the sums, partitioned by position, not by id. The ids
//    are Zipf-skewed: ids below 1,024 hold 77-79% of a table's positions,
//    so a block that owned an id range (the first port) did most of its
//    table's work alone. Here a warp owns one table, a chunk of kChunk
//    consecutive sorted positions (lane l the kLanePos positions from
//    l * kLanePos) and kRowsInFlight rows c: every warp has the same work
//    whatever the skew. It reads its rows of the chunk (16-byte loads, all
//    in flight together) and the chunk's ids, marks where runs begin and
//    end, and takes a segmented inclusive scan of each row: in position
//    order within the lane, then across the lanes by a shuffle tree. This
//    much runs while the map is cleared. The scan at each run's last
//    position is the run's record: records land in the chunk's own stretch
//    of the scratch, in run order, and the map takes record slot + 1 at
//    the run's id. Each chunk also keeps the scan at its last position.
// 3. segment_fixup: a run that crosses chunks (the hot ids: the longest is
//    about 1,500 positions at N 8192, 11,800 at 65,536) is summed from the
//    chunks' last-position scans by a segmented scan over the chunks, in
//    chunk order, one warp a (table, row); its record (the first of the
//    chunk where it ends) takes the sum. It runs only where N is over one
//    chunk.
// 4. segment_write: every output element once, in order, in 16-byte
//    stores: its record where the map has one, else 0. The output is
//    written once, whole, at close to the rate of a plain fill; stores of
//    the sums straight into the output after a fill (4 bytes a run and
//    row, onto lines the fill had already sent to memory) measured slower.
// The order of every sum is fixed by the positions alone, so two calls
// give the same bits, and K7, which runs the same passes with another
// layout in the last, gives K3's bits.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; K3 at N 8192 / 65,536 and K7
// at 8192 on chip_smoke.py's inputs; passes from chip_smoke.py's
// profiles, the rest from tools/segmat_readings.py's `variants`, each
// build timed in turns beside the wrapper):
// - K3 0.099 / 0.189 ms, K7 0.101 ms: map clear 0.004 / 0.006 (it
//   overlaps the sums' reads), sums 0.014 / 0.088, fix-up 0.003 / 0.013,
//   write 0.073 / 0.084. A write pass that stores only zeros (the floor
//   of these stores) makes K3 0.085 / 0.165 ms and K7 0.086.
// - Chunks of 128 positions (kLanePos 4): K3 0.099 / 0.189 ms against
//   0.106 / 0.190 at 256 and 0.116 / 0.206 at 512; K7 0.101 against 0.109
//   and 0.119. More chunks mean more warps at N 8192 and a longer fix-up.
// - Four launches, each a programmatic dependent of the one before:
//   launched plainly, K3 takes 0.104 / 0.195 ms and K7 0.106. The fix-up
//   is 0.003 / 0.013 ms of that, the most that folding it into another
//   pass could save.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Programmatic dependent launch (Hopper): a pass launched with
// launch_after may begin while the pass before it drains; it waits here
// before it touches what that pass writes. let_next_begin lets the next
// pass begin at once.
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void let_next_begin() {
  asm volatile("griddepcontrol.launch_dependents;");
}

constexpr int kLanePos = 4;            // sorted positions a lane holds
constexpr int kChunk = 32 * kLanePos;  // sorted positions a warp owns
constexpr int kSumThreads = 128;       // 4 chunks a block
constexpr int kRowsInFlight = 4;       // rows a warp owns, their loads in flight together
constexpr int kFixThreads = 128;       // 4 (table, row) pairs a block
constexpr int kFixItems = 16;          // chunks a lane of the fix-up holds, at most
constexpr int kClearThreads = 256;
constexpr int kWriteThreads = 256;
constexpr int kWriteVecs = 4;          // 16-byte stores a thread of the write pass makes
constexpr int kRowsThreads = 256;      // K6's one launch: 8 warps a block
constexpr int kRowsBlocksPerSm = 2;    // its grid, at most: a grid-wide barrier costs more with more blocks
static_assert(kLanePos % 4 == 0 && kLanePos <= 32, "whole 16-byte loads, one mask bit each");

// Pass 1: n zero words from p, 16-byte aligned; thread i of `stride`.
__device__ __forceinline__ void clear_words(unsigned* p, long long n, long long i,
                                            long long stride) {
  uint4* p4 = reinterpret_cast<uint4*>(p);
  for (long long k = i; k < n >> 2; k += stride) p4[k] = make_uint4(0u, 0u, 0u, 0u);
  for (long long k = (n >> 2 << 2) + i; k < n; k += stride) p[k] = 0u;
}

__global__ void __launch_bounds__(kClearThreads) map_clear_kernel(unsigned* p, long long n) {
  let_next_begin();  // the sums read and scan before they wait for the clear
  clear_words(p, n, (long long)blockIdx.x * kClearThreads + threadIdx.x,
              (long long)gridDim.x * kClearThreads);
}

// Inclusive segmented scan over the lanes of a warp, in lane order: a lane
// whose `head` is set starts a new segment. The sums take a fixed order
// (a shuffle tree).
__device__ __forceinline__ float warp_segmented_scan(float x, bool head) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFull, x, off);
    const bool up_head = __shfl_up_sync(kFull, (int)head, off);
    if (lane >= off) {
      if (!head) x = up + x;
      head = head || up_head;
    }
  }
  return x;
}

// In place, x becomes the inclusive segmented scan of the warp's 32 *
// kItems values, lane l holding items l * kItems + e; bit e of `head`
// starts a new segment at item e. `carry` goes in front of the warp's
// first segment (lane 0's items before its first head). Returns, in each
// lane, the scan just before its first item.
template <int kItems>
__device__ __forceinline__ float chunk_scan(float (&x)[kItems], unsigned head, float carry) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 1; e < kItems; ++e)
    if (!(head >> e & 1)) x[e] = x[e - 1] + x[e];
  const int first = head ? __ffs(head) - 1 : kItems;
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      if (e < first) x[e] = carry + x[e];
  }
  const float incl = warp_segmented_scan(x[kItems - 1], head != 0);
  float before = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) {
    before = carry;
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      if (e < first) x[e] = before + x[e];
  }
  return before;
}

// The scratch: the map (T, V), record slot + 1 of the run of each id, 0
// for none (first: it is cleared with 16-byte stores); the chunks' flags
// (T, chunks); records (T, C, slots), slots = chunks * kChunk, chunk j's
// runs at j * kChunk + their rank in the chunk; the scan at each chunk's
// last position (T, C, chunks).
struct Scratch {
  unsigned* map;
  unsigned* flags;
  float* rec;
  float* last;
  int* run_id;  // K6's one launch (one table), in place of the map: each record's id
  int* runs;    // and each chunk's count of records
  long long slots;
  int chunks;
};

Scratch carve(float* base, int t, int c, int n, int v) {
  Scratch s;
  s.chunks = (int)(((long long)n + kChunk - 1) / kChunk);
  s.slots = (long long)s.chunks * kChunk;
  s.map = reinterpret_cast<unsigned*>(base);
  s.flags = s.map + (size_t)t * v;
  s.rec = reinterpret_cast<float*>(s.flags + (size_t)t * s.chunks);
  s.last = s.rec + (size_t)t * c * s.slots;
  s.run_id = s.runs = nullptr;
  return s;
}

long long scratch_floats(int t, int c, int n, int v) {
  const long long chunks = ((long long)n + kChunk - 1) / kChunk;
  return (long long)t * (v + chunks) + (long long)t * c * (chunks * kChunk + chunks);
}

// Pass 2: one warp a (table t, chunk j, kRowsInFlight rows from ch0). A
// table's cotangents lie (C, N), row c at stride N (K3, K7), or, for K6's
// one table (kOneTable), (N, C), position p at stride C; K6 also keeps
// each record's id and each chunk's count of records in place of the map.
// kVec: 16-byte loads of the ids, and of the cotangents where a row's
// positions are contiguous.
template <bool kVec, bool kOneTable>
__device__ __forceinline__ void sum_chunk(const int* __restrict__ sids,
                                          const float* __restrict__ sg, int c, int n, int v,
                                          const Scratch& sc, int j, int t, int ch0) {
  const int lane = threadIdx.x & 31;
  const int p0 = j * kChunk, pend = min(p0 + kChunk, n);
  const int q0 = p0 + lane * kLanePos;
  const bool whole = q0 + kLanePos <= n;  // every position of the lane exists

  float x[kRowsInFlight][kLanePos];
  // the lane's first position in row ch0, and the strides of rows and positions
  const size_t row_stride = kOneTable ? 1 : n, pos_stride = kOneTable ? c : 1;
  const float* g = sg + (size_t)t * c * n + ch0 * row_stride + q0 * pos_stride;
#pragma unroll
  for (int r = 0; r < kRowsInFlight; ++r) {
    const float* gr = g + r * row_stride;
    if (ch0 + r >= c) {
#pragma unroll
      for (int e = 0; e < kLanePos; ++e) x[r][e] = 0.0f;
    } else if (kVec && !kOneTable && whole) {
#pragma unroll
      for (int u = 0; u < kLanePos; u += 4) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(gr + u));
        x[r][u] = w.x; x[r][u + 1] = w.y; x[r][u + 2] = w.z; x[r][u + 3] = w.w;
      }
    } else {
      // K6's rows: the warp's loads of one (row, e) lie 4 * C floats apart;
      // the chunk's kChunk * C floats stay in L1 for the other rows
#pragma unroll
      for (int e = 0; e < kLanePos; ++e)
        x[r][e] = q0 + e < n ? __ldg(gr + e * pos_stride) : 0.0f;
    }
  }

  const int* s = sids + (size_t)t * n;
  int id[kLanePos];
  if (kVec && whole) {
#pragma unroll
    for (int u = 0; u < kLanePos; u += 4) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(s + q0 + u));
      id[u] = w.x; id[u + 1] = w.y; id[u + 2] = w.z; id[u + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kLanePos; ++e) id[e] = q0 + e < n ? __ldg(s + q0 + e) : 0;
  }
  int before = __shfl_up_sync(kFull, id[kLanePos - 1], 1);
  int after = __shfl_down_sync(kFull, id[0], 1);
  if (lane == 0 && p0 > 0) before = __ldg(s + p0 - 1);
  if (lane == 31 && pend < n) after = __ldg(s + pend);
  // head: a run begins here (a position past n begins an empty run that
  // ends nowhere); tail: a run ends here; last: the chunk's last position
  unsigned head = 0, tail = 0, last = 0;
#pragma unroll
  for (int e = 0; e < kLanePos; ++e) {
    const int p = q0 + e;
    if (p >= n) {
      head |= 1u << e;
      continue;
    }
    const int prev = e > 0 ? id[e - 1] : before;
    const int next = e + 1 < kLanePos ? id[e + 1] : after;
    if (p == 0 || prev != id[e]) head |= 1u << e;
    if (p == n - 1 || next != id[e]) tail |= 1u << e;
    if (p == pend - 1) last |= 1u << e;
  }
  // the rank of the lane's first run end among the chunk's
  const int ends = __popc(tail);
  int rank = ends;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, rank, off);
    if (lane >= off) rank += up;
  }
  rank += j * kChunk - ends;  // the record slot of the lane's first run end
#pragma unroll
  for (int r = 0; r < kRowsInFlight; ++r)
    if (ch0 + r < c) chunk_scan(x[r], head, 0.0f);

  wait_for_previous();  // the map's clear: every store of this pass comes after it
  if (ch0 == 0 && kOneTable) {
#pragma unroll
    for (int e = 0; e < kLanePos; ++e)
      if (tail >> e & 1) sc.run_id[rank + __popc(tail & ((1u << e) - 1))] = id[e];
    if (lane == 31) sc.runs[j] = rank + ends - j * kChunk;
  } else if (ch0 == 0) {
    unsigned* m = sc.map + (size_t)t * v;
#pragma unroll
    for (int e = 0; e < kLanePos; ++e)
      if ((tail >> e & 1) && id[e] >= 0 && id[e] < v)
        m[id[e]] = rank + __popc(tail & ((1u << e) - 1)) + 1;
  }
  if (ch0 == 0) {
    // the chunk's flags for the fix-up: its first id continues a run from
    // the chunk before, its last id goes on into the next, it is one run
    const int first_id = __shfl_sync(kFull, id[0], 0);
    const bool from_left = __shfl_sync(kFull, p0 > 0 && before == id[0], 0);
    if (last) {
      int last_id = id[0];
#pragma unroll
      for (int e = 1; e < kLanePos; ++e)
        if (last >> e & 1) last_id = id[e];
      sc.flags[(size_t)t * sc.chunks + j] = (from_left ? 1u : 0u) |
                                            (pend < n && after == last_id ? 2u : 0u) |
                                            (first_id == last_id ? 4u : 0u);
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsInFlight; ++r) {
    const int ch = ch0 + r;
    if (ch >= c) break;
    float* rec = sc.rec + ((size_t)t * c + ch) * sc.slots + rank;
#pragma unroll
    for (int e = 0; e < kLanePos; ++e)
      if (tail >> e & 1) rec[__popc(tail & ((1u << e) - 1))] = x[r][e];
#pragma unroll
    for (int e = 0; e < kLanePos; ++e)
      if (last >> e & 1) sc.last[((size_t)t * c + ch) * sc.chunks + j] = x[r][e];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kSumThreads)
segment_sums_kernel(const int* __restrict__ sids, const float* __restrict__ sg, int c, int n,
                    int v, Scratch sc) {
  const int j = blockIdx.x * (kSumThreads / 32) + (threadIdx.x >> 5);
  if (j >= sc.chunks) return;  // a whole warp: nothing here syncs the block
  sum_chunk<kVec, false>(sids, sg, c, n, v, sc, j, blockIdx.y, blockIdx.z * kRowsInFlight);
}

// Pass 3: one warp a (table, row). Item j is chunk j's last-position scan;
// the scan over the items restarts at every chunk but one that is a single
// run carried in from the left, so the scan at chunk j - 1 is what a run
// that crosses into chunk j carries. Where such a run ends in chunk j, its
// sum is that scan plus its record there (its first: the run's part in
// chunk j), and the record takes the sum. row = t * c + ch.
__device__ __forceinline__ void fix_row(int c, const Scratch& sc, int row) {
  const int lane = threadIdx.x & 31;
  const unsigned* flags = sc.flags + (size_t)(row / c) * sc.chunks;
  float* rec = sc.rec + (size_t)row * sc.slots;
  const float* lst = sc.last + (size_t)row * sc.chunks;
  // chunks a lane takes, in position order; items past them carry its
  // last scan on unchanged
  const int k_items = min(kFixItems, (sc.chunks + 31) / 32);
  float carry = 0.0f;  // the scan at the previous tile's last chunk
  for (int j0 = 0; j0 < sc.chunks; j0 += 32 * k_items) {
    float x[kFixItems], f[kFixItems];
    unsigned head = 0, ends = 0;
#pragma unroll
    for (int e = 0; e < kFixItems; ++e) {
      const int j = j0 + lane * k_items + e;
      x[e] = f[e] = 0.0f;
      if (e >= k_items) continue;
      if (j >= sc.chunks) {
        head |= 1u << e;
        continue;
      }
      const unsigned fl = flags[j];
      const bool from_left = fl & 1u, to_right = fl & 2u, one_run = fl & 4u;
      if (!(one_run && from_left)) head |= 1u << e;
      if (from_left && !(one_run && to_right)) ends |= 1u << e;
      x[e] = lst[j];
      f[e] = rec[(size_t)j * kChunk];  // read only where a run ends here
    }
    float prev = chunk_scan(x, head, carry);
#pragma unroll
    for (int e = 0; e < kFixItems; ++e) {
      if (ends >> e & 1) rec[(size_t)(j0 + lane * k_items + e) * kChunk] = prev + f[e];
      prev = x[e];
    }
    carry = __shfl_sync(kFull, x[kFixItems - 1], 31);
  }
}

__global__ void __launch_bounds__(kFixThreads)
segment_fixup_kernel(int t_count, int c, Scratch sc) {
  const int row = blockIdx.x * (kFixThreads / 32) + (threadIdx.x >> 5);
  wait_for_previous();
  if (row < t_count * c) fix_row(c, sc, row);
}

// One output of the write pass: `rows` record rows from row0, laid out
// (T, rows, V) or, id-major, (T, V, rows).
struct Output {
  float* p;
  int rows, row0;
  bool id_major;
};

// Pass 4: blockIdx.y is a line of output blockIdx.z: a (T, rows, V)
// output's lines are its T * rows rows of V elements, an id-major
// output's its T tables of V * rows. A thread writes kWriteVecs 16-byte
// stretches of the line, gridDim.x * kWriteThreads stretches apart, each
// element its record where the map has one, else 0.
__global__ void __launch_bounds__(kWriteThreads)
segment_write_kernel(Output o0, Output o1, int t_count, int c, int v, Scratch sc) {
  wait_for_previous();
  const Output o = blockIdx.z ? o1 : o0;
  const int line = blockIdx.y;
  if (line >= (o.id_major ? t_count : t_count * o.rows)) return;
  const int t = o.id_major ? line : line / o.rows;
  const int len = o.id_major ? v * o.rows : v;
  float* dst = o.p + (size_t)line * len;
  const unsigned* m = sc.map + (size_t)t * v;
  const float* rec = sc.rec + ((size_t)t * c + o.row0 + (o.id_major ? 0 : line - t * o.rows)) *
                                  sc.slots;
  auto value = [&](int k) {  // element k of the line
    const int id = o.id_major ? k / o.rows : k;
    const unsigned slot = __ldg(m + id);
    return slot ? rec[(size_t)(k - (o.id_major ? id * o.rows : k)) * sc.slots + slot - 1] : 0.0f;
  };
  // elements before the line's first 16-byte boundary, and after its last
  const int head = min(len, (int)((4 - (((size_t)line * len) & 3)) & 3));
  const int vecs = (len - head) >> 2;
  const int tail0 = head + 4 * vecs;
  const int i = blockIdx.x * kWriteThreads + threadIdx.x;
  if (i < head) dst[i] = value(i);
  if (i < len - tail0) dst[tail0 + i] = value(tail0 + i);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const bool whole_ids = o.id_major && o.rows % 4 == 0;  // then head is 0: one id a stretch
#pragma unroll
  for (int u = 0; u < kWriteVecs; ++u) {
    const int q = i + u * gridDim.x * kWriteThreads;
    if (q >= vecs) break;
    const int k = head + 4 * q;
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (whole_ids) {
      const int id = k / o.rows;
      const unsigned slot = __ldg(m + id);
      if (slot) {
        const float* r = rec + (size_t)(k - id * o.rows) * sc.slots + slot - 1;
        w = make_float4(r[0], r[sc.slots], r[2 * sc.slots], r[3 * sc.slots]);
      }
    } else {
      w = make_float4(value(k), value(k + 1), value(k + 2), value(k + 3));
    }
    d4[q] = w;
  }
}

// K6: one table with (N, C) cotangents in one launch, over a grid that is
// resident whole (a cooperative launch), with a grid-wide barrier after
// each phase but the last: (1) the sums, each warp a task as in the sums
// pass, with each record's id in place of the map, and zeros over the
// whole output; (2) the fix-up; (3) each record's C sums to its id's row. The sums and
// their order are the passes' own (griddepcontrol.wait is a no-op here:
// no launch before this one is programmatic).
template <bool kVec>
__global__ void __launch_bounds__(kRowsThreads)
one_table_kernel(const int* __restrict__ sids, const float* __restrict__ sg, int c, int n,
                    int v, float* out, Scratch sc) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const long long i = (long long)blockIdx.x * kRowsThreads + threadIdx.x;
  const long long threads = (long long)gridDim.x * kRowsThreads;
  // warps numbered across blocks first, so that a phase with fewer tasks
  // than warps spreads them over every SM
  const long long warp = (long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const long long warps = threads >> 5;
  const long long tasks = (long long)sc.chunks * ((c + kRowsInFlight - 1) / kRowsInFlight);
  for (long long task = warp; task < tasks; task += warps)  // neighbouring warps, neighbouring chunks
    sum_chunk<kVec, true>(sids, sg, c, n, v, sc, (int)(task % sc.chunks), 0,
                          (int)(task / sc.chunks) * kRowsInFlight);
  clear_words(reinterpret_cast<unsigned*>(out), (long long)v * c, i, threads);
  grid.sync();
  if (sc.chunks > 1) {
    for (long long row = warp; row < c; row += warps) fix_row(c, sc, (int)row);
    grid.sync();
  }
  // neighbouring threads take one record's neighbouring rows: one id's
  // row of the output, in order; ids outside [0, v) land nowhere
  for (long long w = i; w < sc.slots * c; w += threads) {
    const long long slot = w / c;
    const int row = (int)(w - slot * c);
    if ((int)(slot % kChunk) >= sc.runs[slot / kChunk]) continue;
    const int id = sc.run_id[slot];
    if (id >= 0 && id < v) out[(size_t)id * c + row] = sc.rec[(size_t)row * sc.slots + slot];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Launches kernel as a programmatic dependent of the launch before it on
// the stream (see wait_for_previous).
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, int threads, cudaStream_t stream,
                         Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The four passes on `stream`; the last writes o0 (record rows from 0) and
// o1 (the rows after o0's; rows 0 for none).
int launch_segment_sums(const int* sids, const float* sg, float* scratch, int t, int c, int n,
                        int v, Output o0, Output o1, cudaStream_t stream) {
  // the longest line and the most lines of the outputs (o1 is never id-major)
  const long long most = o0.id_major ? (long long)v * o0.rows : v;
  const long long lines = (long long)t * (o0.id_major ? (o1.rows > 1 ? o1.rows : 1) : o0.rows);
  // past the grids' dimensions, or an id-major line past the write pass's
  // int offsets
  if ((long long)t * c > (1 << 24) || (c + kRowsInFlight - 1) / kRowsInFlight > 65535 ||
      lines > 65535 || (o0.id_major && most > (1 << 30)))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(scratch)) return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Scratch sc = carve(scratch, t, c, n, v);
  map_clear_kernel<<<sms * (2048 / kClearThreads), kClearThreads, 0, stream>>>(
      sc.map, (long long)t * v);
  const dim3 grid((sc.chunks + kSumThreads / 32 - 1) / (kSumThreads / 32), t,
                  (c + kRowsInFlight - 1) / kRowsInFlight);
  const bool vec = n % 4 == 0 && aligned16(sids) && aligned16(sg);
  err = launch_after(vec ? segment_sums_kernel<true> : segment_sums_kernel<false>, grid,
                     kSumThreads, stream, sids, sg, c, n, v, sc);
  if (err == cudaSuccess && sc.chunks > 1) {
    const int pairs = kFixThreads / 32;
    err = launch_after(segment_fixup_kernel, dim3((t * c + pairs - 1) / pairs), kFixThreads, stream,
                       t, c, sc);
  }
  const long long per_block = (long long)kWriteThreads * kWriteVecs * 4;
  if (err == cudaSuccess)
    err = launch_after(segment_write_kernel,
                       dim3((unsigned)((most + per_block - 1) / per_block), (unsigned)lines,
                            o1.rows ? 2 : 1),
                       kWriteThreads, stream, o0, o1, t, c, v, sc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K6 on `stream` as one cooperative launch of one_table_kernel: sg (n, c),
// out (v, c). Its grid is what the largest phase needs, at most
// kRowsBlocksPerSm blocks an SM (fewer where the kernel's registers allow
// fewer), counted once a device.
int launch_one_table(const int* sids, const float* sg, float* scratch, int c, int n, int v,
                float* out, cudaStream_t stream) {
  if (!aligned16(scratch)) return (int)cudaErrorMisalignedAddress;
  constexpr int kDevices = 64;
  static int resident[kDevices];  // blocks that fit at once, per device (0: not counted yet)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int fit = dev < kDevices ? resident[dev] : 0;
  if (fit == 0) {
    int sms = 0, vec_blocks = 0, scalar_blocks = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&vec_blocks, one_table_kernel<true>,
                                                          kRowsThreads, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &scalar_blocks, one_table_kernel<false>, kRowsThreads, 0);
    if (err != cudaSuccess) return (int)err;
    fit = sms * min(kRowsBlocksPerSm, min(vec_blocks, scalar_blocks));
    if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (dev < kDevices) resident[dev] = fit;
  }
  Scratch sc = carve(scratch, 1, c, n, v);
  sc.run_id = reinterpret_cast<int*>(sc.last + (size_t)c * sc.chunks);
  sc.runs = sc.run_id + sc.slots;
  // blocks for a warp a sums task, a thread 16 bytes of zeros, or a thread
  // an element of the records
  const long long tasks = (long long)sc.chunks * ((c + kRowsInFlight - 1) / kRowsInFlight);
  const long long need = std::max({(tasks * 32 + kRowsThreads - 1) / kRowsThreads,
                                   ((long long)v * c / 4 + kRowsThreads - 1) / kRowsThreads,
                                   (sc.slots * c + kRowsThreads - 1) / kRowsThreads});
  const int blocks = (int)std::min<long long>(need, fit);
  const bool vec = n % 4 == 0 && aligned16(sids);
  void* args[] = {&sids, &sg, &c, &n, &v, &out, &sc};
  err = cudaLaunchCooperativeKernel(
      vec ? (void*)one_table_kernel<true> : (void*)one_table_kernel<false>, blocks,
      kRowsThreads, args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch that K3 and K7 take for t tables, c rows, n positions
// and v ids: the records, one a position, the chunks' last-position scans
// and the (t, v) map.
extern "C" long long segment_matmul_scratch_floats(int t, int c, int n, int v) {
  return scratch_floats(t, c, n, v);
}

// Floats of scratch that K6 takes: K3's at t = 1, then each record's id
// and each chunk's count of records for its one launch.
extern "C" long long segment_matmul_rows_scratch_floats(int c, int n, int v) {
  const long long chunks = ((long long)n + kChunk - 1) / kChunk;
  return scratch_floats(1, c, n, v) + chunks * kChunk + chunks;
}

// Launches K3 on `stream`: sids (t, n) int32, each row sorted ascending;
// sg (t, c, n) f32; out (t, c, v) f32, every element written, 16-byte
// aligned; scratch segment_matmul_scratch_floats(t, c, n, v) f32, 16-byte
// aligned. Returns cudaGetLastError() after the launches (or
// cudaErrorInvalidValue for empty or oversized shapes,
// cudaErrorMisalignedAddress for out or scratch).
extern "C" int segment_matmul_sorted_batched(const void* sids, const void* sg, void* out,
                                             void* scratch, int t, int c, int n, int v,
                                             void* stream) {
  if (t < 1 || t > 65535 || c < 1 || n < 1 || v < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(out)) return (int)cudaErrorMisalignedAddress;
  return launch_segment_sums(static_cast<const int*>(sids), static_cast<const float*>(sg),
                             static_cast<float*>(scratch), t, c, n, v,
                             Output{static_cast<float*>(out), c, 0, false},
                             Output{nullptr, 0, 0, false}, static_cast<cudaStream_t>(stream));
}

// K7: K3's batched segment sum with row-major table output, the backward
// of the split packed lookup under SEGMAT_VK_OUT.
//
// Replaces the TPU kernel
// recman_tpu/ops/embedding.py:_segment_matmul_from_sorted_batched_vk
// (reached from _lookup_multi_split_bwd). The wrapper is
// recman_tpu_torch/ops/segment_matmul.py:segment_matmul_from_sorted_batched_vk.
//
// What it computes: sorted ids (T, N) int32 and the cotangents permuted
// into that order, transposed, (T, k_emb + n_vec, N) f32, give the table
// grads (T, V, k_emb) f32, row-major, and the vector grads (T, n_vec, V)
// f32: K3's sums, with the first k_emb rows of each column written as one
// row of the table grad. Rows with no id are exact zeros; ids outside
// [0, V) land nowhere.
//
// Bound on an H100 SXM: bytes, as K3. At the bench geometry (T = 26,
// k_emb = 16, n_vec = 1, N = 8192, V = 100,001) it writes 176.8 MB and
// reads 15.3 MB: 0.057 ms at 3.35 TB/s. The row-major output is the
// point: Adam and the forward gathers take a (V, k) table's grad as it
// lands, with no transpose of K3's (k, V) block.
//
// Design: K3's four passes (above); the write pass lays the records of
// rows below k_emb out id-major, a table's grad as one stretch of 16-byte
// stores, and the others as K3 does. The sums are K3's records, so K7
// gives K3's bits.

// Launches K7 on `stream`: sids (t, n) int32, each row sorted ascending;
// sg (t, k_emb + n_vec, n) f32; out_emb (t, v, k_emb) f32 and out_vec (t,
// n_vec, v) f32, every element written, 16-byte aligned (out_vec unused
// when n_vec is 0); scratch segment_matmul_scratch_floats(t, k_emb +
// n_vec, n, v) f32, 16-byte aligned. Returns cudaGetLastError() after the
// launches (or cudaErrorInvalidValue for empty or oversized shapes,
// cudaErrorMisalignedAddress for an output or the scratch).
extern "C" int segment_matmul_sorted_batched_vk(const void* sids, const void* sg,
                                                void* out_emb, void* out_vec, void* scratch,
                                                int t, int k_emb, int n_vec, int n, int v,
                                                void* stream) {
  if (t < 1 || t > 65535 || k_emb < 1 || n_vec < 0 || n < 1 || v < 1)
    return (int)cudaErrorInvalidValue;
  float* emb = static_cast<float*>(out_emb);
  float* vec = n_vec ? static_cast<float*>(out_vec) : nullptr;
  if (!aligned16(emb) || (vec && !aligned16(vec))) return (int)cudaErrorMisalignedAddress;
  return launch_segment_sums(static_cast<const int*>(sids), static_cast<const float*>(sg),
                             static_cast<float*>(scratch), t, k_emb + n_vec, n, v,
                             Output{emb, k_emb, 0, true}, Output{vec, n_vec, k_emb, false},
                             static_cast<cudaStream_t>(stream));
}

// K6: the sorted segment sum of one table's lookup backward, row-major, on
// K3's sums and fix-up.
//
// Replaces the TPU kernel
// recman_tpu/ops/embedding.py:_segment_matmul_from_sorted (reached through
// _segment_matmul_grad from _lookup_bwd under grad_kernel("segmat")). The
// wrapper is recman_tpu_torch/ops/segment_matmul.py:segment_matmul_from_sorted.
//
// What it computes: sorted ids (N,) int32 and the cotangent rows permuted
// into that order, (N, C) f32 row-major, give the dense grad (V, C) f32
// row-major, as the TPU kernel writes it: row v is the f32 sum of the
// cotangent rows whose id is v, 0 where no id falls; ids outside [0, V)
// land nowhere.
//
// Bound on an H100 SXM: bytes. It reads the ids and the cotangents once and
// writes the zero-filled (V, C) grad once; the N*C adds are nothing. On the
// ML-100K train step (N = 128 or 2,432, V <= 1,574, C = 9) that is under
// 0.1 MB, so a launch costs more than the bytes; at one Criteo table (N =
// 8,192, V = 100,001, C = 17) it is 7.4 MB, 2.2 us at 3.35 TB/s, and the
// zero fill dominates.
//
// Design: K3's split by position, in one launch. The first port gave each
// block 256 consecutive ids; Zipf ids below 1,024 hold most of a Criteo
// table's positions and ML-100K's genres put most of 2,432 rows on id 0,
// so one block did nearly all the work while the others wrote zeros.
// Split by position, every warp has the same work. K6 runs K7's sums
// (sum_chunk, reading the (N, C) rows in place) and fix-up at T = 1, so
// its sums are K7's bits at T = 1 on the transposed cotangents (k_emb =
// C, n_vec = 0), and two calls give the same bits.
//
// K6 on K3's four launches cost the host 0.025 ms a call, against
// index_add_'s 0.013, and its passes took less than that on the card, so
// a call's time was the host's. So K6 is one cooperative launch,
// one_table_kernel: the sums and zeros over the output, a grid-wide
// barrier, the fix-up, a barrier, then each run's record copied to its
// id's row. It keeps no map, so there is no map to clear and no map
// lookup per output element.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's profiles,
// tools/segmat_readings.py's timing and phases): at one Criteo table (N
// 8192, V 100,001, C 17) 0.0105 ms of kernel (sums and zeros 5.8 us,
// fix-up 2.3, scatter 1.6; a barrier 1.4), 0.037-0.040 ms a call
// event-timed, set by the host, as index_add_'s 0.035-0.045; the first
// port took 0.063. At the genres ids 0.0077 ms of kernel. With V
// 1,000,001 (a 68 MB output, past L2) 0.035 ms, the zeros 26 us of it.

// Launches K6 on `stream`: sids (n,) int32, sorted ascending; sg (n, c) f32
// row-major; out (v, c) f32 row-major, every element written, 16-byte
// aligned; scratch segment_matmul_rows_scratch_floats(c, n, v) f32,
// 16-byte aligned. Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for empty shapes, cudaErrorMisalignedAddress for
// out or the scratch).
extern "C" int segment_matmul_sorted_rows(const void* sids, const void* sg, void* out,
                                          void* scratch, int c, int n, int v, void* stream) {
  if (c < 1 || n < 1 || v < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(out)) return (int)cudaErrorMisalignedAddress;
  return launch_one_table(static_cast<const int*>(sids), static_cast<const float*>(sg),
                          static_cast<float*>(scratch), c, n, v, static_cast<float*>(out),
                          static_cast<cudaStream_t>(stream));
}
