// Shared pieces of the port's tensor-core weight-only matmuls on Hopper
// (sm_90a): the bf16 m16n8k16 mma with f32 accumulation, the exact int8 to
// bf16 pair conversion, and 16-byte cp.async staging. Plain C++ and inline PTX:
// no include path beyond the CUDA toolkit.
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// for lane l of a warp, g = l / 4 and t = l % 4 (PTX ISA, "Matrix
// fragments for mma.m16n8k16"):
//   A (16 x 16, row): a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//                     a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8, col):  b[0] = B[2t, 2t+1][g]      b[1] = B[2t+8, 2t+9][g]
//   C (16 x 8, f32):  c[0], c[1] = C[g][2t, 2t+1]
//                     c[2], c[3] = C[g+8][2t, 2t+1]
// Each 32-bit register holds two bf16, the lower k (or column) in the low
// half. The sum over k does not care which physical k each logical k is,
// so the kernels permute k within a step, the same way on A and B, until a
// lane's elements are contiguous in memory (ops/mma_layout.py writes each
// kernel's mapping out and checks it on the CPU).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace ft {

// d += a * b, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two int8 at bits 0-7 and 16-23 of t (the other bits are ignored) as one
// bf16x2 word, exact: 128 + (v & 127) and 128 - 128 (v < 0) are built in
// the mantissa of bf16 128 (0x4300) by one LOP3 each, and one bf16x2
// subtract gives (v & 127) - 128 (v < 0) = v. Four instructions a pair
// with the PRMT that gathers it, and none on the slower I2F pipe.
__device__ __forceinline__ uint32_t s8pair_to_bf16x2(uint32_t t) {
  const uint32_t mag = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (t & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 a, b;
  memcpy(&a, &mag, 4);
  memcpy(&b, &off, 4);
  const __nv_bfloat162 r = __hsub2(a, b);
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// Four int8 (byte i = element i) as two bf16x2 words: lo = (e0, e1),
// hi = (e2, e3).
__device__ __forceinline__ void s8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  lo = s8pair_to_bf16x2(__byte_perm(w, 0u, 0x4140));
  hi = s8pair_to_bf16x2(__byte_perm(w, 0u, 0x4342));
}

// Byte c of w0 and byte c of w1 as one bf16x2 word (w0's in the low
// half). ``c`` is a constant after unrolling, so the selector is an
// immediate.
__device__ __forceinline__ uint32_t s8_column_pair(uint32_t w0, uint32_t w1,
                                                   int c) {
  return s8pair_to_bf16x2(__byte_perm(w0, w1, c * 0x11 + (4 + c) * 0x1100));
}

// 16-byte asynchronous copy global -> shared; bytes past src_bytes (0 or
// 16) are zero-filled, and none are read. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace ft
