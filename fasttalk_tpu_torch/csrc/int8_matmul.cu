// Int8 weight-only matmuls for decode on Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; ops/cuda_int8.py).
//
// Replaces the Pallas TPU kernels of fasttalk_tpu/ops/pallas_int8.py:
//   int8_matmul   (:89, body _mm_kernel :70)
//       y[M,N] = (x[M,K] @ q[K,N]) * s[N], f32 accumulate, scale once.
//   int8_matmul_t (:127, body _mm_t_kernel :118)
//       y[M,V] = x[M,D] @ (q[V,D] * s[V])^T, no transpose materialised.
//
// Both are bound by the int8 weight bytes at decode batch sizes (M <= 16):
// every weight byte is read once, x and y are KiB. The designs keep the
// weight stream coalesced and keep x on chip:
//
// int8_matmul: a block owns a 256-column tile of N and a K range of at least
//   64 rows (split-K: the grid's y axis), about two blocks per SM where the
//   weight is large enough. 256 threads = 64 column groups of 4 columns x 4
//   row groups; a
//   warp reads 128 contiguous bytes of a weight row per step. x's K range is
//   staged in shared memory as float and read by broadcast. Accumulators
//   (M x 4 floats) live in registers; the row groups reduce through shared
//   memory and each split stores its partial sums to its own slice of an
//   f32 workspace [splits, M, N]. A second small kernel sums the splits in
//   split order, applies s[N] in f32 and casts once, so the result does not
//   depend on the order in which blocks run.
//
// int8_matmul_t: one block per SM walks vocab rows. x [M, D] sits in
//   shared memory as float (dynamic shared memory, up to 227 KB); each warp
//   owns groups of 32 consecutive vocab rows and works on 4 rows at a time,
//   reading them with 16-byte loads (lane l takes bytes 16l.. of every
//   512-byte span), so each x value read from shared memory feeds 4 rows.
//   At M=16 the f32 multiply-adds, not the bytes, set this kernel's pace
//   (tensor cores are a later step). The per-row dot products reduce across
//   the warp by shuffles; lane r keeps row r's sums so the 32 outputs of a
//   group are written as one coalesced store per x row.
//
// Every entry point returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXM = 16;          // x rows per launch tile (grid.z tiles M)
constexpr int MM_THREADS = 256;   // int8_matmul block
constexpr int MM_COLS = 256;      // columns per int8_matmul block
constexpr int MM_KCHUNK = 128;    // staged K rows of x per pass
constexpr int MT_THREADS = 256;   // int8_matmul_t block (8 warps)
constexpr int MT_ROWS = 4;        // vocab rows a warp works on at once

__device__ __forceinline__ float q2f(int8_t v) { return static_cast<float>(v); }

__global__ void __launch_bounds__(MM_THREADS)
mm_splitk_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
                 const int8_t* __restrict__ q,          // [K, N]
                 float* __restrict__ ws,                // [splits, M, N]
                 int M, int K, int N, int k_per_split) {
  __shared__ float xs[MAXM][MM_KCHUNK];
  __shared__ float red[3][MM_THREADS / 4 * 4];

  const int tid = threadIdx.x;
  const int cg = tid & 63;        // column group (4 columns)
  const int rg = tid >> 6;        // row group 0..3
  const int n0 = blockIdx.x * MM_COLS + cg * 4;
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

  for (int kc = k_begin; kc < k_end; kc += MM_KCHUNK) {
    const int kn = min(MM_KCHUNK, k_end - kc);
    __syncthreads();
    for (int i = tid; i < MAXM * MM_KCHUNK; i += MM_THREADS) {
      const int m = i / MM_KCHUNK, kk = i % MM_KCHUNK;
      xs[m][kk] = (m < mt && kk < kn)
          ? __bfloat162float(x[(size_t)(m0 + m) * K + kc + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = rg; kk < kn; kk += 4) {
      const int8_t* row = q + (size_t)(kc + kk) * N;
      float w[4];
      if (vec) {
        const char4 v = *reinterpret_cast<const char4*>(row + n0);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = (n0 + j < N) ? q2f(row[n0 + j]) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m < mt) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
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

__global__ void sum_scale_cast_kernel(const float* __restrict__ ws,
                                      const float* __restrict__ s,
                                      __nv_bfloat16* __restrict__ y,
                                      int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += ws[sp * mn + i];
  y[i] = __float2bfloat16(acc * s[i % N]);
}

__global__ void __launch_bounds__(MT_THREADS, 1)
mm_t_kernel(const __nv_bfloat16* __restrict__ x,   // [M, D]
            const int8_t* __restrict__ q,          // [V, D]
            const float* __restrict__ s,            // [V]
            __nv_bfloat16* __restrict__ y,         // [M, V]
            int M, int D, int V, int m_tile) {
  extern __shared__ float xs[];                     // [m_tile, D]
  const int m0 = blockIdx.y * m_tile;
  const int mt = min(m_tile, M - m0);
  for (int i = threadIdx.x; i < mt * D; i += blockDim.x)
    xs[i] = __bfloat162float(x[(size_t)m0 * D + i]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int groups = (V + 31) / 32;
  const bool vec = (D & 15) == 0;

  for (int g = blockIdx.x * warps + warp; g < groups; g += gridDim.x * warps) {
    float out[MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) out[m] = 0.f;
    const int rows = min(32, V - g * 32);
    const int8_t* group = q + (size_t)g * 32 * D;
    // MT_ROWS rows at a time: each x value read from shared memory feeds
    // MT_ROWS fused multiply-adds.
    for (int r0 = 0; r0 < rows; r0 += MT_ROWS) {
      float acc[MT_ROWS][MAXM];
#pragma unroll
      for (int rb = 0; rb < MT_ROWS; ++rb)
#pragma unroll
        for (int m = 0; m < MAXM; ++m) acc[rb][m] = 0.f;
      if (vec) {
        for (int d = lane * 16; d < D; d += 512) {
          int4 chunk[MT_ROWS];
#pragma unroll
          for (int rb = 0; rb < MT_ROWS; ++rb)
            chunk[rb] = r0 + rb < rows
                ? *reinterpret_cast<const int4*>(group + (size_t)(r0 + rb) * D + d)
                : make_int4(0, 0, 0, 0);
          float w[MT_ROWS][16];
#pragma unroll
          for (int rb = 0; rb < MT_ROWS; ++rb) {
            const int words[4] = {chunk[rb].x, chunk[rb].y, chunk[rb].z,
                                  chunk[rb].w};
#pragma unroll
            for (int e = 0; e < 16; ++e)
              w[rb][e] = static_cast<float>(
                  static_cast<int8_t>(words[e >> 2] >> (8 * (e & 3))));
          }
#pragma unroll
          for (int m = 0; m < MAXM; ++m) {
            if (m < mt) {
              const float4* xp = reinterpret_cast<const float4*>(xs + m * D + d);
#pragma unroll
              for (int e4 = 0; e4 < 4; ++e4) {
                const float4 xv = xp[e4];
#pragma unroll
                for (int rb = 0; rb < MT_ROWS; ++rb) {
                  float a = acc[rb][m];
                  a = fmaf(xv.x, w[rb][4 * e4 + 0], a);
                  a = fmaf(xv.y, w[rb][4 * e4 + 1], a);
                  a = fmaf(xv.z, w[rb][4 * e4 + 2], a);
                  a = fmaf(xv.w, w[rb][4 * e4 + 3], a);
                  acc[rb][m] = a;
                }
              }
            }
          }
        }
      } else {
        for (int d = lane; d < D; d += 32) {
          float w[MT_ROWS];
#pragma unroll
          for (int rb = 0; rb < MT_ROWS; ++rb)
            w[rb] = r0 + rb < rows ? q2f(group[(size_t)(r0 + rb) * D + d]) : 0.f;
#pragma unroll
          for (int m = 0; m < MAXM; ++m) {
            if (m < mt) {
              const float xv = xs[m * D + d];
#pragma unroll
              for (int rb = 0; rb < MT_ROWS; ++rb)
                acc[rb][m] = fmaf(xv, w[rb], acc[rb][m]);
            }
          }
        }
      }
#pragma unroll
      for (int rb = 0; rb < MT_ROWS; ++rb) {
#pragma unroll
        for (int m = 0; m < MAXM; ++m) {
          if (m < mt) {
            float a = acc[rb][m];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              a += __shfl_xor_sync(0xffffffffu, a, off);
            if (lane == r0 + rb) out[m] = a;
          }
        }
      }
    }
    const int v = g * 32 + lane;
    if (lane < rows) {
      const float sv = s[v];
#pragma unroll
      for (int m = 0; m < MAXM; ++m)
        if (m < mt) y[(size_t)(m0 + m) * V + v] = __float2bfloat16(out[m] * sv);
    }
  }
}

}  // namespace

extern "C" {

// x [M, K] bf16, q [K, N] int8, s [N] f32 -> y [M, N] bf16. ws holds
// splits * M * N floats, splits = ceil(K / k_per_split); the kernels write
// all of it before reading it, so it needs no zeroing.
int ft_int8_matmul(const void* x, const void* q, const void* s, void* ws,
                   void* y, int M, int K, int N, int k_per_split,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (K + k_per_split - 1) / k_per_split;
  const dim3 grid((N + MM_COLS - 1) / MM_COLS, splits, (M + MAXM - 1) / MAXM);
  mm_splitk_kernel<<<grid, MM_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<float*>(ws), M, K, N, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)M * N;
  sum_scale_cast_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(s),
      static_cast<__nv_bfloat16*>(y), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

// x [M, D] bf16, q [V, D] int8, s [V] f32 -> y [M, V] bf16.
// m_tile rows of x per block (<= 16); shared memory m_tile * D * 4 bytes.
int ft_int8_matmul_t(const void* x, const void* q, const void* s, void* y,
                     int M, int D, int V, int m_tile, int blocks,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)m_tile * D * sizeof(float);
  // Raise the kernel's shared-memory limit once per size seen (not on every
  // launch: the call stays out of CUDA-graph captures after the first use).
  static size_t smem_allowed = 0;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        mm_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const dim3 grid(blocks, (M + m_tile - 1) / m_tile);
  mm_t_kernel<<<grid, MT_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(y), M, D, V,
      m_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
