// K3: the batched segment sum of the stacked embedding backward, and K6,
// its one-table form with row-major output (below K3).
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
// 3.35 TB/s; the 3.6 MFLOP of adds are nothing. The zero-filled output
// dominates, so every column is written exactly once, in coalesced rows.
//
// Design (deterministic, no atomics on the output):
// - A block owns one table and 1,024 consecutive columns. Two threads
//   find by binary search where the block's ids begin and end in the
//   sorted row; the block then walks those positions once and marks where
//   each column's run starts and ends (shared memory). A first version
//   searched once per column (13 dependent loads in each of 257 threads
//   a block) and was latency-bound.
// - Each thread owns 4 columns, 256 apart, so the writes of a warp
//   coalesce. A run of at most kShort ids is summed by its thread, in
//   position order, four rows c at a time with the position loop
//   unrolled, so that many loads are in flight (the hot first block of a
//   table holds most short runs and sets the kernel's time); empty
//   columns write 0.
// - The data is Zipf-skewed: the most frequent id takes about 18% of a
//   table's rows (about 1,500 of 8,192). One lane, or even one warp, would
//   serialise that run, so the block's long runs are listed and summed by
//   all its warps together: warp w takes rows c = w, w+8, ..., its lanes
//   take positions 32 apart into 4 independent sums (so 4 loads are in
//   flight), which are added in a fixed order and then by a fixed
//   butterfly. Every sum has a fixed order, so the result is the same
//   from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kCols = kThreads * kPerThread;  // columns per block
constexpr int kShort = 32;                    // longer runs are summed by the block

__device__ __forceinline__ int first_at_least(const int* s, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(s + mid) < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Marks, for the ids [v0, v1) of one sorted row s (n positions), where
// each id's run begins and ends (run_begin/run_end[id - v0], 0 and 0 for
// an id with no run), with the whole block. range[2] is shared scratch.
__device__ __forceinline__ void mark_runs(const int* s, int n, int v0, int v1, int cols,
                                          int* run_begin, int* run_end, int* range) {
  const int tid = threadIdx.x;
  if (tid < 2) range[tid] = first_at_least(s, n, tid == 0 ? v0 : v1);
  for (int i = tid; i < cols; i += kThreads) run_begin[i] = run_end[i] = 0;
  __syncthreads();
  const int p0 = range[0], p1 = range[1];
  for (int p = p0 + tid; p < p1; p += kThreads) {
    const int id = __ldg(s + p);
    if (p == p0 || __ldg(s + p - 1) != id) run_begin[id - v0] = p;
    if (p == p1 - 1 || __ldg(s + p + 1) != id) run_end[id - v0] = p + 1;
  }
  __syncthreads();
}

// One thread sums a short run (positions a .. a+cnt-1) of each of the c
// rows of g (row stride n) in position order, four rows at a time with
// the position loop unrolled, so that up to 16 loads are in flight;
// store(row, sum). An empty run stores 0.
template <typename Store>
__device__ __forceinline__ void sum_short_run(const float* g, int n, int a, int cnt, int c,
                                              Store store) {
  for (int ch0 = 0; ch0 < c; ch0 += 4) {
    const int nc = min(4, c - ch0);
    const float* gr = g + (size_t)ch0 * n + a;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int p = 0; p < cnt; ++p) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < nc) acc[u] += __ldg(gr + (size_t)u * n + p);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < nc) store(ch0 + u, acc[u]);
  }
}

// The whole block sums a long run: warp w takes rows c = w, w+8, ..., its
// lanes take positions 32 apart into 4 independent sums (so 4 loads are
// in flight), which are added in a fixed order and then by a fixed
// butterfly; lane 0 stores.
template <typename Store>
__device__ __forceinline__ void sum_long_run(const float* g, int n, int a, int cnt, int c,
                                             Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int ch = warp; ch < c; ch += kThreads / 32) {
    const float* gr = g + (size_t)ch * n + a;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int p = lane;
    for (; p + 96 < cnt; p += 128) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += __ldg(gr + p + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (p + 32 * u < cnt) acc[u] += __ldg(gr + p + 32 * u);
    float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) store(ch, sum);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_matmul_kernel(const int* sids, const float* sg, float* out, int c, int n, int v) {
  __shared__ int run_begin[kCols], run_end[kCols], long_cols[kCols];
  __shared__ int range[2], n_long;
  const int t = blockIdx.y;
  const int v0 = blockIdx.x * kCols;
  const int v1 = min(v0 + kCols, v);
  const int tid = threadIdx.x;
  if (tid == 0) n_long = 0;
  mark_runs(sids + (size_t)t * n, n, v0, v1, kCols, run_begin, run_end, range);

  const float* g = sg + (size_t)t * c * n;
  float* o = out + (size_t)t * c * v;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    const int col = v0 + i;
    if (col >= v1) break;
    const int a = run_begin[i], cnt = run_end[i] - a;
    if (cnt > kShort) {
      long_cols[atomicAdd(&n_long, 1)] = i;  // list order does not change any sum
      continue;
    }
    sum_short_run(g, n, a, cnt, c, [&](int ch, float sum) { o[(size_t)ch * v + col] = sum; });
  }
  __syncthreads();

  for (int q = 0; q < n_long; ++q) {
    const int i = long_cols[q];
    const int a = run_begin[i], cnt = run_end[i] - a;
    sum_long_run(g, n, a, cnt, c, [&](int ch, float sum) { o[(size_t)ch * v + v0 + i] = sum; });
  }
}

}  // namespace

// Launches K3 on `stream`: sids (t, n) int32, each row sorted ascending;
// sg (t, c, n) f32; out (t, c, v) f32, every element written. Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for empty
// or oversized shapes).
extern "C" int segment_matmul_sorted_batched(const void* sids, const void* sg, void* out,
                                             int t, int c, int n, int v, void* stream) {
  if (t < 1 || t > 65535 || c < 1 || n < 1 || v < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((v + kCols - 1) / kCols, t);
  segment_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sids), static_cast<const float*>(sg),
      static_cast<float*>(out), c, n, v);
  return (int)cudaGetLastError();
}

// K6: the sorted segment sum of one table's lookup backward, row-major.
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
// Design (deterministic, no atomics on the output):
// - A block owns kRows consecutive rows of the output, whose (rows, C)
//   tile is one contiguous stretch of memory. It finds its ids' range by
//   binary search and marks where each row's run begins and ends, as K3
//   does per column.
// - Each thread takes elements of the tile in order, so the writes of a
//   warp coalesce, and sums a short run (at most kShort rows) for its
//   element in position order; an empty row writes 0.
// - A long run (ML-100K's genres: the padding ids clamp to id 0, which
//   then takes most of 2,432 rows) is summed by the whole block: thread
//   q*C + c takes column c of the run's rows q, q + S, q + 2S, ... with
//   S = kThreads / C, so each pass of the block reads S whole rows, one
//   contiguous stretch; its 4 partial sums are added in a fixed order,
//   then the S partials of each column in order of q. Every sum has a
//   fixed order, so two calls give the same bits.

namespace {

constexpr int kRows = 256;  // output rows per block

__global__ void __launch_bounds__(kThreads)
segment_rows_kernel(const int* sids, const float* sg, float* out, int c, int n, int v) {
  __shared__ int run_begin[kRows], run_end[kRows], long_rows[kRows];
  __shared__ float partial[kThreads];
  __shared__ int range[2], n_long;
  const int v0 = blockIdx.x * kRows;
  const int v1 = min(v0 + kRows, v);
  const int rows = v1 - v0;
  const int tid = threadIdx.x;
  if (tid < 2) range[tid] = first_at_least(sids, n, tid == 0 ? v0 : v1);
  if (tid == 0) n_long = 0;
  for (int i = tid; i < kRows; i += kThreads) run_begin[i] = run_end[i] = 0;
  __syncthreads();
  const int p0 = range[0], p1 = range[1];
  for (int p = p0 + tid; p < p1; p += kThreads) {
    const int id = __ldg(sids + p);
    if (p == p0 || __ldg(sids + p - 1) != id) run_begin[id - v0] = p;
    if (p == p1 - 1 || __ldg(sids + p + 1) != id) run_end[id - v0] = p + 1;
  }
  __syncthreads();
  for (int i = tid; i < rows; i += kThreads)
    if (run_end[i] - run_begin[i] > kShort)
      long_rows[atomicAdd(&n_long, 1)] = i;  // list order does not change any sum

  float* o = out + (size_t)v0 * c;
  for (int e = tid; e < rows * c; e += kThreads) {
    const int i = e / c, col = e - i * c;
    const int a = run_begin[i], cnt = run_end[i] - a;
    if (cnt > kShort) continue;
    const float* g = sg + (size_t)a * c + col;
    float acc = 0.0f;
#pragma unroll 4
    for (int p = 0; p < cnt; ++p) acc += __ldg(g + (size_t)p * c);
    o[e] = acc;
  }
  __syncthreads();

  const int step = kThreads / c;  // rows of a run read per pass of the block
  const int q = tid / c, col = tid - q * c;
  for (int r = 0; r < n_long; ++r) {
    const int i = long_rows[r];
    const int a = run_begin[i], cnt = run_end[i] - a;
    if (q < step) {
      const float* g = sg + (size_t)a * c + col;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int p = q;
      for (; p + 3 * step < cnt; p += 4 * step) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] += __ldg(g + (size_t)(p + u * step) * c);
      }
#pragma unroll
      for (int u = 0; u < 3; ++u)
        if (p + u * step < cnt) acc[u] += __ldg(g + (size_t)(p + u * step) * c);
      partial[tid] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();
    if (tid < c) {
      float sum = 0.0f;
      for (int j = 0; j < step; ++j) sum += partial[j * c + tid];
      o[(size_t)i * c + tid] = sum;
    }
    __syncthreads();
  }
}

}  // namespace

// Launches K6 on `stream`: sids (n,) int32, sorted ascending; sg (n, c) f32
// row-major; out (v, c) f32 row-major, every element written. Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for empty
// shapes or c > 256).
extern "C" int segment_matmul_sorted_rows(const void* sids, const void* sg, void* out,
                                          int c, int n, int v, void* stream) {
  if (c < 1 || c > kThreads || n < 1 || v < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)v + kRows - 1) / kRows);
  segment_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sids), static_cast<const float*>(sg),
      static_cast<float*>(out), c, n, v);
  return (int)cudaGetLastError();
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
// Design (deterministic, no atomics on the output): K3's, with a block
// owning kColsVK ids. Each run is summed exactly as K3 sums it (the same
// helpers: short runs by one thread in position order, long runs by the
// whole block in a fixed order), so K7 and K3 give the same bits. The
// sums land in a (kColsVK, k_eff) tile in shared memory (an odd row
// stride, so that a warp's stores hit distinct banks), and the block then
// writes its kColsVK x k_emb table rows as one contiguous, coalesced
// stretch (64-byte rows at k_emb 16) and each vector row's kColsVK values
// after it.

namespace {

constexpr int kColsVK = 512;                   // ids per block
constexpr int kPerThreadVK = kColsVK / kThreads;
constexpr int kMaxEffVK = 96;                  // k_emb + n_vec: the tile fits shared memory

__global__ void __launch_bounds__(kThreads)
segment_matmul_vk_kernel(const int* sids, const float* sg, float* out_emb, float* out_vec,
                         int k_emb, int n_vec, int n, int v) {
  extern __shared__ float tile[];              // kColsVK x stride
  __shared__ int run_begin[kColsVK], run_end[kColsVK], long_cols[kColsVK];
  __shared__ int range[2], n_long;
  const int c = k_emb + n_vec;
  const int stride = c | 1;
  const int t = blockIdx.y;
  const int v0 = blockIdx.x * kColsVK;
  const int v1 = min(v0 + kColsVK, v);
  const int rows = v1 - v0;
  const int tid = threadIdx.x;
  if (tid == 0) n_long = 0;
  mark_runs(sids + (size_t)t * n, n, v0, v1, kColsVK, run_begin, run_end, range);

  const float* g = sg + (size_t)t * c * n;
#pragma unroll
  for (int k = 0; k < kPerThreadVK; ++k) {
    const int i = tid + k * kThreads;
    if (i >= rows) break;
    const int a = run_begin[i], cnt = run_end[i] - a;
    if (cnt > kShort) {
      long_cols[atomicAdd(&n_long, 1)] = i;  // list order does not change any sum
      continue;
    }
    sum_short_run(g, n, a, cnt, c, [&](int ch, float sum) { tile[i * stride + ch] = sum; });
  }
  __syncthreads();
  for (int q = 0; q < n_long; ++q) {
    const int i = long_cols[q];
    const int a = run_begin[i], cnt = run_end[i] - a;
    sum_long_run(g, n, a, cnt, c, [&](int ch, float sum) { tile[i * stride + ch] = sum; });
  }
  __syncthreads();

  float* oe = out_emb + ((size_t)t * v + v0) * k_emb;
  for (int e = tid; e < rows * k_emb; e += kThreads) {
    const int i = e / k_emb;
    oe[e] = tile[i * stride + (e - i * k_emb)];
  }
  for (int j = 0; j < n_vec; ++j) {
    float* ov = out_vec + ((size_t)t * n_vec + j) * v + v0;
    for (int i = tid; i < rows; i += kThreads) ov[i] = tile[i * stride + k_emb + j];
  }
}

}  // namespace

// Launches K7 on `stream`: sids (t, n) int32, each row sorted ascending;
// sg (t, k_emb + n_vec, n) f32; out_emb (t, v, k_emb) f32 and out_vec (t,
// n_vec, v) f32, every element written (out_vec unused when n_vec is 0).
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for empty or oversized shapes, or k_emb + n_vec over 96).
extern "C" int segment_matmul_sorted_batched_vk(const void* sids, const void* sg,
                                                void* out_emb, void* out_vec, int t, int k_emb,
                                                int n_vec, int n, int v, void* stream) {
  if (t < 1 || t > 65535 || k_emb < 1 || n_vec < 0 || k_emb + n_vec > kMaxEffVK || n < 1 ||
      v < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = kColsVK * ((k_emb + n_vec) | 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      segment_matmul_vk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((v + kColsVK - 1) / kColsVK, t);
  segment_matmul_vk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sids), static_cast<const float*>(sg),
      static_cast<float*>(out_emb), static_cast<float*>(out_vec), k_emb, n_vec, n, v);
  return (int)cudaGetLastError();
}
