// Shared by the tensor-core kernels: cp.async copies into shared memory,
// ldmatrix fragment loads and the warp-level mma.sync products (sm_80 and
// later, so also Hopper's sm_90a).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 / m16n8k8"),
// with g = lane / 4 and t = lane % 4:
//   C, D (16 x 8, fp32):  c0, c1 = (g, 2t), (g, 2t + 1); c2, c3 = the same at row g + 8.
//   bf16 m16n8k16:  A (16 x 16, row) a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//                   a2 = (g, 2t+8..), a3 = (g + 8, 2t+8..);
//                   B (16 x 8, col)  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g).
//   tf32 m16n8k8:   A (16 x 8, row)  a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
//                   a3 = (g + 8, t + 4);  B (8 x 8, col) b0 = (t, g), b1 = (t + 4, g).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, or 16 zeros when !ok (src-size
// 0: nothing is read, but src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes, or 4 zeros when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m.
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

// An 8 x 8 b16 matrix in ldmatrix's layout (lane l holds row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1, the lower column in the low half),
// transposed across the warp: lane l then holds row l / 4 of the transpose.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d += a * b, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, tf32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both tf32 (x's upper 19 bits, then those of the rest, each
// with the low 13 mantissa bits cleared): a product with an exact second
// operand then keeps about 21 of x's 24 mantissa bits, where hi alone
// keeps 11.  Masks rather than cvt.rna.tf32.f32, which issues at a fraction
// of the ALU rate and held the scan's products back.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// (a, b) = hi + lo, each a bf16 pair as an mma operand takes it (a in the
// low half): a product with an exact second operand then keeps about 16 of
// a's 24 mantissa bits, where hi alone keeps 8.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(a, b);
  lo = pack_bf16x2(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
}

// A bf16's bits as the fp32 (and tf32) value it holds: exact.
__device__ __forceinline__ uint32_t bf16_bits_to_tf32(uint16_t b) {
  return static_cast<uint32_t>(b) << 16;
}

}  // namespace repro
