// Tensor-core building blocks shared by K4 (cin_interact_fwd.cu) and K5
// (cin_interact_bwd.cu): cp.async staging, ldmatrix and the warp-level
// bf16 product mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//
// Fragments of m16n8k16 (g = lane / 4, q = lane % 4), as the PTX ISA
// defines them:
// - A (16 x 16, row-major), 4 registers of two bf16: a0 = A[g][2q..2q+1],
//   a1 = A[g+8][2q..], a2 = A[g][2q+8..], a3 = A[g+8][2q+8..];
// - B (16 x 8, "col"), 2 registers: b0 = B[2q..2q+1][g], b1 = B[2q+8..][g];
// - C (16 x 8, f32), 4 registers: c0, c1 = C[g][2q..2q+1], c2, c3 =
//   C[g+8][2q..2q+1].
// The lower 16 bits of a register hold the lower index.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and receives register i from matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two 8 x 8 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a . b, bf16 operands, f32 sums. Registers only, so not volatile:
// the compiler may move it among the loads.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 products, each rounded once to bf16 (the product of two bf16
// values is exact in f32, so this is bf16(bf16(x) * bf16(y))).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t y) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                             *reinterpret_cast<const __nv_bfloat162*>(&y));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 4 consecutive f32 of a row from column col, 0 past bd; one 16-byte load
// where bd is a multiple of 4.
__device__ __forceinline__ float4 load4(const float* row, int col, int bd) {
  if ((bd & 3) == 0 && col + 3 < bd) return *reinterpret_cast<const float4*>(row + col);
  return make_float4(col < bd ? row[col] : 0.f, col + 1 < bd ? row[col + 1] : 0.f,
                     col + 2 < bd ? row[col + 2] : 0.f, col + 3 < bd ? row[col + 3] : 0.f);
}

// One bf16 value in both halves.
__device__ __forceinline__ uint32_t dup_bf16(__nv_bfloat16 v) {
  const uint32_t u = *reinterpret_cast<const uint16_t*>(&v);
  return u | (u << 16);
}

// 4 f32 rounded to bf16, in order, as 8 bytes.
__device__ __forceinline__ uint2 pack_bf16x4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

}  // namespace tc
