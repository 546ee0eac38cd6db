// Int4 weight-only matmul for decode on Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; ops/cuda_int4.py).
//
// Replaces the Pallas TPU kernel of fasttalk_tpu/ops/pallas_int8.py:
//   int4_matmul (:242, body _mm4_kernel :208)
//       y[M,N] = x[M,K] @ W,  W[k,n] = bf16(q[k,n] * bf16(s[k/G, n])),
//       q the sign-extended nibbles of q4[K/2, N]: packed row j holds row 2j
//       in its low nibble and row 2j+1 in its high nibble. f32 accumulation,
//       one cast to bf16, no scale after the dot (the group scale varies
//       along K, so it cannot be factored out as int8_matmul's s[N] is).
//
// The weight is rounded exactly as the TPU kernel rounds it: q * bf16(s) is
// exact in f32 (4 + 8 significant bits), so bf16_rn of that product is the
// only rounding, and kernel, plain version and JAX agree on every weight.
//
// Bound: at decode batch sizes (M <= 16) the packed weight bytes (half of
// int8's) plus the f32 group scales (1/G of the weights, 4 bytes each).
// The design is int8_matmul.cu's, two weight rows per byte:
//   a block owns a 256-column tile of N and a K range of at least 64 rows
//   (split-K: the grid's y axis; every split starts on an even row, so no
//   split cuts a nibble pair), about two blocks per SM. 256 threads = 64
//   column groups of 4 columns x 4 row groups; a warp reads 128 contiguous
//   bytes of one packed row per step, i.e. 8 weights a thread (2 rows x 4
//   columns). x's K range is staged in shared memory as float and read by
//   broadcast. A thread keeps its 4 columns' group scales (rounded to bf16)
//   in registers and re-reads them only when its rows enter a new group.
//   Accumulators (M x 4 floats) live in registers; the row groups reduce
//   through shared memory and each split stores its partial sums to its own
//   slice of an f32 workspace [splits, M, N]; a second small kernel sums the
//   splits in split order and casts once, so the result does not depend on
//   the order in which blocks run. At M = 16 the f32 multiply-adds on the
//   CUDA cores, not the bytes, set the pace (tensor cores are a later step).
//
// Every entry point returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXM = 16;        // x rows per launch tile (grid.z tiles M)
constexpr int THREADS = 256;
constexpr int COLS = 256;       // columns per block
constexpr int KCHUNK = 128;     // staged K rows of x per pass (64 packed rows)

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__global__ void __launch_bounds__(THREADS)
mm4_splitk_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
                  const uint8_t* __restrict__ q4,        // [K/2, N]
                  const float* __restrict__ s,           // [K/G, N]
                  float* __restrict__ ws,                // [splits, M, N]
                  int M, int K, int N, int G, int k_per_split) {
  __shared__ float xs[MAXM][KCHUNK];
  __shared__ float red[3][COLS];

  const int tid = threadIdx.x;
  const int cg = tid & 63;        // column group (4 columns)
  const int rg = tid >> 6;        // row group 0..3 (one per pair of warps)
  const int n0 = blockIdx.x * COLS + cg * 4;
  const int m0 = blockIdx.z * MAXM;
  const int mt = min(MAXM, M - m0);
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool vec = ((N & 3) == 0) && (n0 + 3 < N);

  float acc[MAXM][4];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  int group_end = -1;             // first row past the scales held in sc

  for (int kc = k_begin; kc < k_end; kc += KCHUNK) {
    const int kn = min(KCHUNK, k_end - kc);   // even: K and splits are even
    __syncthreads();
    for (int i = tid; i < MAXM * KCHUNK; i += THREADS) {
      const int m = i / KCHUNK, kk = i % KCHUNK;
      xs[m][kk] = (m < mt && kk < kn)
          ? __bfloat162float(x[(size_t)(m0 + m) * K + kc + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 2 * rg; kk < kn; kk += 8) {
      const int k = kc + kk;        // the low nibble's row; k + 1 the high
      if (k >= group_end) {         // both rows of a pair share a group
        const int g = k / G;
        group_end = (g + 1) * G;
        const float* srow = s + (size_t)g * N;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[j] = (n0 + j < N) ? bf16_rn(srow[n0 + j]) : 0.f;
      }
      const uint8_t* row = q4 + (size_t)(k >> 1) * N;
      uint32_t b4 = 0;
      if (vec) {
        b4 = *reinterpret_cast<const uint32_t*>(row + n0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + j < N) b4 |= (uint32_t)row[n0 + j] << (8 * j);
      }
      float wlo[4], whi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Byte j: bits 8j..8j+3 (row k) and 8j+4..8j+7 (row k + 1), each
        // sign-extended by moving it to the top and shifting back.
        const int lo = static_cast<int>(b4 << (28 - 8 * j)) >> 28;
        const int hi = static_cast<int>(b4 << (24 - 8 * j)) >> 28;
        wlo[j] = bf16_rn(static_cast<float>(lo) * sc[j]);
        whi[j] = bf16_rn(static_cast<float>(hi) * sc[j]);
      }
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m < mt) {
          const float2 xv = *reinterpret_cast<const float2*>(&xs[m][kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[m][j] = fmaf(xv.y, whi[j], fmaf(xv.x, wlo[j], acc[m][j]));
        }
      }
    }
  }

  // Reduce the four row groups, one x row at a time, then store the block's
  // partial sums in its split's slice of the workspace.
  float* part = ws + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m >= mt) break;
    __syncthreads();
    if (rg > 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) red[rg - 1][cg * 4 + j] = acc[m][j];
    }
    __syncthreads();
    if (rg == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = acc[m][j] + red[0][cg * 4 + j] + red[1][cg * 4 + j]
                        + red[2][cg * 4 + j];
        if (n0 + j < N) part[(size_t)(m0 + m) * N + n0 + j] = v;
      }
    }
  }
}

__global__ void sum_cast_kernel(const float* __restrict__ ws,
                                __nv_bfloat16* __restrict__ y, size_t mn,
                                int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += ws[sp * mn + i];
  y[i] = __float2bfloat16(acc);
}

}  // namespace

extern "C" {

// x [M, K] bf16, q4 [K/2, N] uint8, s [K/G, N] f32 -> y [M, N] bf16.
// K and G even, G | K, k_per_split even. ws holds splits * M * N floats,
// splits = ceil(K / k_per_split); the kernels write all of it before
// reading it, so it needs no zeroing.
int ft_int4_matmul(const void* x, const void* q4, const void* s, void* ws,
                   void* y, int M, int K, int N, int G, int k_per_split,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (K + k_per_split - 1) / k_per_split;
  const dim3 grid((N + COLS - 1) / COLS, splits, (M + MAXM - 1) / MAXM);
  mm4_splitk_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4),
      static_cast<const float*>(s), static_cast<float*>(ws), M, K, N, G,
      k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)M * N;
  sum_cast_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(y), total,
      splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
