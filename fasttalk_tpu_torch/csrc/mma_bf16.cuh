// Shared pieces of the port's tensor-core kernels on Hopper (sm_90a): the
// bf16 m16n8k16 mma with f32 accumulation, the exact int8 to bf16 pair
// conversion, 16-byte cp.async staging, and the split-K epilogue and
// cluster launch of the weight-only matmuls (int8_matmul.cu,
// int4_matmul.cu). Plain C++ and inline PTX: no include path beyond the
// CUDA toolkit.
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

#include <cooperative_groups.h>

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

// Two floats rounded to bf16 as one word, a in the low half.
__device__ __forceinline__ uint32_t bf16x2_rn(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t out;
  memcpy(&out, &h, 4);
  return out;
}

// The first n (<= 4) bytes at p as one word, byte e at bits 8e; 0 past n.
__device__ __forceinline__ uint32_t pack4(const void* p, int n) {
  const uint8_t* b = static_cast<const uint8_t*>(p);
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) w |= static_cast<uint32_t>(b[e]) << (8 * e);
  return w;
}

// Zero x rows mt_rows .. rows - 1 (stride xs bf16, at byte x_off of each
// of STAGES ring stages of stage_bytes) once: the stage loads write only
// the rows below M, so the mma reads zeros for the tile's missing rows.
template <int THREADS, int STAGES>
__device__ __forceinline__ void zero_x_tail(uint8_t* smem, int stage_bytes,
                                            int x_off, int xs, int rows,
                                            int mt_rows) {
  const int per_row = xs / 8;   // 16-byte pieces of a row
  const int per_stage = (rows - mt_rows) * per_row;
  for (int i = threadIdx.x; i < STAGES * per_stage; i += THREADS) {
    const int st = i / per_stage, rem = i % per_stage;
    const int r = mt_rows + rem / per_row, j = rem % per_row;
    *reinterpret_cast<uint4*>(smem + st * stage_bytes + x_off
                              + (r * xs + 8 * j) * 2) = make_uint4(0, 0, 0, 0);
  }
}

// Epilogue of the split-K weight matmuls. A block of 4 warps holds, per m16
// tile, four n8 tiles a warp whose column g is weight column 4g + c, so
// lane t's accumulators are 8 contiguous output columns 32 warp + 8t ..
// +7: acc[mt][c][0], [1] at columns 8t + c, 8t + 4 + c of row g, [2], [3]
// the same of row g + 8. Each output is multiplied by s[n] when s is given
// (times 1, exactly, when it is null) and cast to bf16 once. With one
// split the block stores its tile. Otherwise the splits (grid.y) of the
// column tile are one thread block cluster: each block's f32 sums go to
// its own shared memory (smem, free of the ring by then), and each block
// sums 1/splits of the tile's float4 column groups over every block of the
// cluster in split order and stores them, so the bits do not depend on
// which block finishes first.
template <int MT, int BN, int THREADS, int MAX_SPLITS>
__device__ __forceinline__ void splitk_epilogue(
    uint8_t* smem, const float (&acc)[MT][4][4], __nv_bfloat16* y,
    const float* s, int m0, int mt_rows, int N, int n_blk) {
  constexpr int PS = BN + 4;   // partial tile row stride in floats
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c_l = warp * 32 + 8 * t;
  const int splits = gridDim.y;
  if (splits == 1) {
    const int n_l = n_blk + c_l;
    const bool full8 = (N & 7) == 0 && n_l + 8 <= N
                       && (reinterpret_cast<uintptr_t>(s) & 15) == 0;
    float sc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sc[j] = s == nullptr ? 1.f : (full8 || n_l + j < N ? s[n_l + j] : 0.f);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r >= mt_rows) continue;
        float v[8];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] = acc[mt][c][2 * h] * sc[c];
          v[4 + c] = acc[mt][c][2 * h + 1] * sc[4 + c];
        }
        __nv_bfloat16* out = y + (size_t)(m0 + r) * N + n_l;
        if (full8) {
          *reinterpret_cast<uint4*>(out) = make_uint4(
              bf16x2_rn(v[0], v[1]), bf16x2_rn(v[2], v[3]),
              bf16x2_rn(v[4], v[5]), bf16x2_rn(v[6], v[7]));
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (n_l + j < N) out[j] = __float2bfloat16(v[j]);
        }
      }
    }
    return;
  }
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);   // [MT * 16][PS]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r >= mt_rows) continue;
      float4* p = reinterpret_cast<float4*>(part + r * PS + c_l);
      p[0] = make_float4(acc[mt][0][2 * h], acc[mt][1][2 * h],
                         acc[mt][2][2 * h], acc[mt][3][2 * h]);
      p[1] = make_float4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1],
                         acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]);
    }
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  const int quads = mt_rows * (BN / 4);
  for (int i = cluster.block_rank() * THREADS + threadIdx.x; i < quads;
       i += splits * THREADS) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    float4 p[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      if (j < splits)
        p[j] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, j) + r * PS + c);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      if (j < splits) {
        a.x += p[j].x; a.y += p[j].y; a.z += p[j].z; a.w += p[j].w;
      }
    const int n = n_blk + c;
    __nv_bfloat16* out = y + (size_t)(m0 + r) * N + n;
    const float o[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N)
        out[j] = __float2bfloat16(o[j] * (s == nullptr ? 1.f : s[n + j]));
  }
  cluster.sync();   // keep this block's sums until every reader is done
}

// Launch a split-K kernel with its splits (grid.y) as one cluster per
// column tile (up to 16 blocks, a non-portable size). Raises the kernel's
// dynamic shared memory limit on its first call, outside any CUDA-graph
// capture that later calls make. Returns the launch's error, if any.
template <auto Kernel, typename... Args>
int launch_split_clusters(dim3 grid, int threads, int smem, cudaStream_t st,
                          Args... args) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = grid.y > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace ft
