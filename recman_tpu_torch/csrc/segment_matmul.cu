// K3: the batched segment sum of the stacked embedding backward.
//
// Replaces the TPU kernel
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

__global__ void __launch_bounds__(kThreads)
segment_matmul_kernel(const int* sids, const float* sg, float* out, int c, int n, int v) {
  __shared__ int run_begin[kCols], run_end[kCols], long_cols[kCols];
  __shared__ int range[2], n_long;
  const int t = blockIdx.y;
  const int v0 = blockIdx.x * kCols;
  const int v1 = min(v0 + kCols, v);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* s = sids + (size_t)t * n;
  if (tid < 2) range[tid] = first_at_least(s, n, tid == 0 ? v0 : v1);
  if (tid == 0) n_long = 0;
  for (int i = tid; i < kCols; i += kThreads) run_begin[i] = run_end[i] = 0;
  __syncthreads();
  const int p0 = range[0], p1 = range[1];
  for (int p = p0 + tid; p < p1; p += kThreads) {
    const int id = __ldg(s + p);
    if (p == p0 || __ldg(s + p - 1) != id) run_begin[id - v0] = p;
    if (p == p1 - 1 || __ldg(s + p + 1) != id) run_end[id - v0] = p + 1;
  }
  __syncthreads();

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
    // four rows at a time, so that up to 16 loads are in flight
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
        if (u < nc) o[(size_t)(ch0 + u) * v + col] = acc[u];
    }
  }
  __syncthreads();

  for (int q = 0; q < n_long; ++q) {
    const int i = long_cols[q];
    const int a = run_begin[i], cnt = run_end[i] - a;
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
      if (lane == 0) o[(size_t)ch * v + v0 + i] = sum;
    }
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
