// Int8 weight-only matmuls for decode on Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; ops/cuda_int8.py).
//
// Replaces the Pallas TPU kernels of fasttalk_tpu/ops/pallas_int8.py:
//   int8_matmul   (:89, body _mm_kernel :70)
//       y[M,N] = (x[M,K] @ q[K,N]) * s[N], f32 accumulate, scale once.
//   int8_matmul_t (:127, body _mm_t_kernel :118)
//       y[M,V] = x[M,D] @ (q[V,D] * s[V])^T, no transpose materialised.
//
// Bound: the int8 weight bytes. At decode batch sizes (M <= 16) a step reads
// 0.97 GB of layer weights and the 262.7 MB lm_head table once; x and y are
// KiB to MiB. The arithmetic (2 M K N) is 31 GFLOP a step at M = 16, 0.03 ms
// on the bf16 tensor cores, so both kernels hand it to them: the TPU kernels'
// dot(x, q.astype(bf16)) with f32 accumulation is what
// mma.sync.m16n8k16.bf16 computes, exactly, since every int8 is a bf16.
//
// Shared design (pieces in mma_bf16.cuh):
// - Weights and x reach shared memory through a 4-stage ring of 16-byte
//   cp.async copies, so a block keeps three stages in flight while it
//   computes on the fourth. Ragged edges are zero-filled by the copy
//   itself (src-size 0). Shapes whose rows are not 16-byte aligned take
//   the same kernel with plain loads into the ring (VEC = false).
// - int8 -> bf16 on the way from shared memory to the mma, in pairs: one
//   byte permute gathers two int8 into the low bytes of a bf16x2 word, two
//   LOP3 build 128 + (v & 127) and 128 (256 if v < 0) in the mantissa of
//   bf16 128, and one bf16x2 subtract leaves v, exactly. Four
//   instructions a pair, none on the quarter-rate I2F pipe.
// - Up to 4 m16 tiles (M <= 64) loop inside the block, so each weight
//   tile is read from device memory once for all of them; larger M takes
//   more groups of 64 rows on the grid.
// - The scale is applied once in f32 after the dot, one cast to bf16; or
//   no cast (out_f32): a tensor-parallel shard's partial product stays
//   f32 until the sum over ranks, which then rounds once, as one rank's
//   whole product does.
//
// int8_matmul (q [K, N], N contiguous): a block owns 128 columns and a K
//   range (split-K on grid.y), 32 columns a warp. The [K, N] layout puts a
//   lane's B elements on four rows, so a lane reads one 4-byte word (4
//   columns) from each of rows 4t .. 4t+3 of a k-step and byte c of the
//   four words fills B of n8 tile c: four n8 tiles at once, no transpose
//   in shared memory. Tile c's column g is weight column 4g + c, so a
//   lane's accumulators are 8 contiguous output columns, 8t .. 8t+7. The
//   k permutation (logical 2t, 2t+1, 2t+8, 2t+9 -> physical 4t .. 4t+3)
//   makes a lane's A elements one 8-byte shared load a row. Weight rows
//   are 128 bytes in shared memory with 16-byte chunk j stored at
//   j ^ (2 ((r / 4) % 4)), which keeps the 4-byte B reads of a warp on 32
//   distinct banks. Up to 16 splits of a column tile run as one thread
//   block cluster: each writes its f32 partial tile to its own shared
//   memory, and after a cluster barrier each block sums 1/splits of the
//   tile over all the cluster's blocks in split order (distributed shared
//   memory), scales, casts and stores. One launch, no workspace in device
//   memory, and the same bits every call whatever the block order.
//
// int8_matmul_t (q [V, D], D contiguous): a block owns 128 vocab rows (32
//   a warp, four n8 tiles) and walks all of D in 128-byte stages. In mma
//   terms B is "col", so a lane's B elements lie on one vocab row: a lane
//   reads 16 contiguous bytes (4 k-steps) of its row, and the k
//   permutation (logical 2t, 2t+1, 2t+8, 2t+9 of step j -> physical
//   16t + 4j .. 16t + 4j + 3) makes its A elements 16 contiguous bf16 a
//   row too. Chunk j of weight row r sits at j ^ (4 (r % 2)); x rows are
//   padded by 16 bytes; both keep the 16-byte shared reads conflict-free.
//   No cross-lane reduction is left: each accumulator is one output,
//   scaled by s[v] in f32 and stored.
//
// ops/mma_layout.py writes both fragment mappings out in Python; the CPU
// tests check them against the plain versions through numpy's m16n8k16.
//
// Every entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using ft::cp_async16;
using ft::cp_async_commit;
using ft::cp_async_wait;
using ft::mma_bf16_16816;
using ft::pack4;
using ft::s8x4_to_bf16x4;

constexpr int THREADS = 128;   // 4 warps, both kernels
constexpr int STAGES = 4;      // cp.async ring depth, both kernels
constexpr int MAX_MT = 4;      // m16 tiles per block

// int8_matmul: 128 columns x 64 weight rows (4 k-steps) a stage; at most
// 16 splits of K (a cluster, non-portable above 8).
constexpr int MAX_SPLITS = 16;
constexpr int MM_BN = 128;
constexpr int MM_BK = 64;
constexpr int MM_XS = MM_BK + 16;   // x row stride in bf16 (160 bytes)
constexpr int MM_PS = MM_BN + 4;    // partial tile row stride in floats

// int8_matmul_t: 128 vocab rows x 128 bytes of D (8 k-steps) a stage.
constexpr int MT_BV = 128;
constexpr int MT_BK = 128;
constexpr int MT_XS = MT_BK + 8;    // x row stride in bf16 (272 bytes)

template <int MT>
struct MmLayout {
  static constexpr int W = MM_BK * MM_BN;           // weight bytes a stage
  static constexpr int STAGE = W + MT * 16 * MM_XS * 2;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(MT * 16 * MM_PS * 4 <= SMEM, "the sum tile fits the ring");
};

template <int MT>
struct MtLayout {
  static constexpr int W = MT_BV * MT_BK;
  static constexpr int STAGE = W + MT * 16 * MT_XS * 2;
  static constexpr int SMEM = STAGES * STAGE;
};

// ------------------------------------------------------------ int8_matmul

template <int MT, bool VEC>
__device__ __forceinline__ void mm_load_stage(
    uint8_t* stage, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ q, int K, int N, int m0, int mt_rows,
    int n_blk, int k0, int k_end) {
  const int tid = threadIdx.x;
  // Weights: MM_BK rows x 8 chunks of 16 bytes, chunk j of row r stored at
  // j ^ (2 ((r / 4) % 4)).
  for (int c = tid; c < MM_BK * (MM_BN / 16); c += THREADS) {
    const int r = c >> 3, j = c & 7;
    const int k = k0 + r, n = n_blk + 16 * j;
    uint8_t* dst = stage + r * MM_BN + ((j ^ (((r >> 2) & 3) << 1)) << 4);
    const int8_t* src = q + (size_t)k * N + n;
    if (VEC) {
      const bool in = k < k_end && n < N;   // N % 16 == 0: whole chunks
      cp_async16(dst, in ? src : q, in ? 16 : 0);
    } else {
      const int cnt = k < k_end ? min(16, N - n) : 0;
      uint4 v;
      v.x = pack4(src, cnt);
      v.y = pack4(src + 4, cnt - 4);
      v.z = pack4(src + 8, cnt - 8);
      v.w = pack4(src + 12, cnt - 12);
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
  // x: mt_rows rows x MM_BK bf16, 8 chunks of 8 a row (the rows past M
  // were zeroed once by zero_x_tail).
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage + MmLayout<MT>::W);
  for (int c = tid; c < mt_rows * (MM_BK / 8); c += THREADS) {
    const int r = c >> 3, j = c & 7;
    const int k = k0 + 8 * j;
    __nv_bfloat16* dst = xs + r * MM_XS + 8 * j;
    const __nv_bfloat16* src = x + (size_t)(m0 + r) * K + k;
    if (VEC) {
      const bool in = k < k_end;   // K % 8 == 0: whole chunks
      cp_async16(dst, in ? src : x, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = k + e < k_end ? src[e] : __float2bfloat16(0.f);
    }
  }
}

template <int MT, bool VEC, typename OutT>
__global__ void __launch_bounds__(THREADS)
mm_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
          const int8_t* __restrict__ q,          // [K, N]
          const float* __restrict__ s,           // [N]
          OutT* __restrict__ y,                  // [M, N]
          int M, int K, int N, int k_per_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  using L = MmLayout<MT>;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_blk = blockIdx.x * MM_BN;
  const int m0 = blockIdx.z * (MT * 16);
  const int mt_rows = min(MT * 16, M - m0);
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int iters = k_end > k_begin ? (k_end - k_begin + MM_BK - 1) / MM_BK : 0;

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][c][i] = 0.f;

  ft::zero_x_tail<THREADS, STAGES>(smem, L::STAGE, L::W, MM_XS, MT * 16,
                                   mt_rows);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < iters)
      mm_load_stage<MT, VEC>(smem + i * L::STAGE, x, q, K, N, m0, mt_rows,
                             n_blk, k_begin + i * MM_BK, k_end);
    cp_async_commit();
  }

  // This lane's B words: 4 columns 32 warp + 4g .. +3, i.e. byte 4 (g % 4)
  // of 16-byte chunk 2 warp + g / 4, on rows 4t + e of each k-step (whose
  // swizzle term is 2t).
  const int b_off = ((((warp << 1) + (g >> 2)) ^ (t << 1)) << 4) + ((g & 3) << 2);

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < iters)
      mm_load_stage<MT, VEC>(smem + (nx % STAGES) * L::STAGE, x, q, K, N,
                             m0, mt_rows, n_blk, k_begin + nx * MM_BK, k_end);
    cp_async_commit();

    const uint8_t* wst = smem + (it % STAGES) * L::STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(wst + L::W);
#pragma unroll
    for (int ks = 0; ks < MM_BK / 16; ++ks) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = *reinterpret_cast<const uint32_t*>(
            wst + (16 * ks + 4 * t + e) * MM_BN + b_off);
      // n8 tile c takes byte c of the four words: rows 4t, 4t+1 (logical
      // k 2t, 2t+1) in b[c][0], rows 4t+2, 4t+3 (2t+8, 2t+9) in b[c][1].
      uint32_t b[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        b[c][0] = ft::s8_column_pair(w[0], w[1], c);
        b[c][1] = ft::s8_column_pair(w[2], w[3], c);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xr = xs + (mt * 16 + g) * MM_XS + 16 * ks + 4 * t;
        const uint2 lo = *reinterpret_cast<const uint2*>(xr);
        const uint2 hi = *reinterpret_cast<const uint2*>(xr + 8 * MM_XS);
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_bf16_16816(acc[mt][c], a, b[c]);
      }
    }
  }
  ft::splitk_epilogue<MT, MM_BN, THREADS, MAX_SPLITS>(smem, acc, y, s, m0,
                                                      mt_rows, N, n_blk);
}

// ---------------------------------------------------------- int8_matmul_t

template <int MT, bool VEC>
__device__ __forceinline__ void mt_load_stage(
    uint8_t* stage, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ q, int D, int V, int m0, int mt_rows,
    int v_blk, int d0) {
  const int tid = threadIdx.x;
  // Weights: MT_BV rows x 8 chunks of 16 bytes, chunk j of row r stored at
  // j ^ (4 (r % 2)).
  for (int c = tid; c < MT_BV * (MT_BK / 16); c += THREADS) {
    const int r = c >> 3, j = c & 7;
    const int v = v_blk + r, d = d0 + 16 * j;
    uint8_t* dst = stage + r * MT_BK + ((j ^ ((r & 1) << 2)) << 4);
    const int8_t* src = q + (size_t)v * D + d;
    if (VEC) {
      const bool in = v < V && d < D;       // D % 16 == 0: whole chunks
      cp_async16(dst, in ? src : q, in ? 16 : 0);
    } else {
      const int cnt = v < V ? min(16, D - d) : 0;
      uint4 w;
      w.x = pack4(src, cnt);
      w.y = pack4(src + 4, cnt - 4);
      w.z = pack4(src + 8, cnt - 8);
      w.w = pack4(src + 12, cnt - 12);
      *reinterpret_cast<uint4*>(dst) = w;
    }
  }
  // x: mt_rows rows x MT_BK bf16, 16 chunks of 8 a row (the rows past M
  // were zeroed once by zero_x_tail).
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage + MtLayout<MT>::W);
  for (int c = tid; c < mt_rows * (MT_BK / 8); c += THREADS) {
    const int r = c >> 4, j = c & 15;
    const int d = d0 + 8 * j;
    __nv_bfloat16* dst = xs + r * MT_XS + 8 * j;
    const __nv_bfloat16* src = x + (size_t)(m0 + r) * D + d;
    if (VEC) {
      const bool in = d < D;       // D % 16 == 0: whole chunks
      cp_async16(dst, in ? src : x, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = d + e < D ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// Two adjacent outputs at an even column (a 4- or 8-byte aligned address).
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int MT, bool VEC, typename OutT>
__global__ void __launch_bounds__(THREADS)
mm_t_kernel(const __nv_bfloat16* __restrict__ x,   // [M, D]
            const int8_t* __restrict__ q,          // [V, D]
            const float* __restrict__ s,           // [V]
            OutT* __restrict__ y,                  // [M, V]
            int M, int D, int V) {
  extern __shared__ __align__(16) uint8_t smem[];
  using L = MtLayout<MT>;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int v_blk = blockIdx.x * MT_BV;
  const int m0 = blockIdx.y * (MT * 16);
  const int mt_rows = min(MT * 16, M - m0);
  const int iters = (D + MT_BK - 1) / MT_BK;

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  ft::zero_x_tail<THREADS, STAGES>(smem, L::STAGE, L::W, MT_XS, MT * 16,
                                   mt_rows);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < iters)
      mt_load_stage<MT, VEC>(smem + i * L::STAGE, x, q, D, V, m0, mt_rows,
                             v_blk, i * MT_BK);
    cp_async_commit();
  }

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < iters)
      mt_load_stage<MT, VEC>(smem + (nx % STAGES) * L::STAGE, x, q, D, V, m0,
                             mt_rows, v_blk, nx * MT_BK);
    cp_async_commit();

    const uint8_t* wst = smem + (it % STAGES) * L::STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(wst + L::W);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // n8 tile nt: vocab row 32 warp + 8 nt + g, bytes 64h + 16t .. +15
      // (chunk 4h + t), i.e. 4 k-steps of this lane.
      uint32_t b[4][4][2];   // [k-step j][tile nt][reg]
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = warp * 32 + nt * 8 + g;
        const uint4 w = *reinterpret_cast<const uint4*>(
            wst + r * MT_BK + (((4 * h + t) ^ ((g & 1) << 2)) << 4));
        s8x4_to_bf16x4(w.x, b[0][nt][0], b[0][nt][1]);
        s8x4_to_bf16x4(w.y, b[1][nt][0], b[1][nt][1]);
        s8x4_to_bf16x4(w.z, b[2][nt][0], b[2][nt][1]);
        s8x4_to_bf16x4(w.w, b[3][nt][0], b[3][nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // Rows g and g + 8, the same 16 bf16: elements 4j .. 4j+3 feed
        // k-step j (words 2j and 2j + 1).
        const __nv_bfloat16* xr = xs + (mt * 16 + g) * MT_XS + 64 * h + 16 * t;
        const uint4 l0 = *reinterpret_cast<const uint4*>(xr);
        const uint4 l1 = *reinterpret_cast<const uint4*>(xr + 8);
        const uint4 h0 = *reinterpret_cast<const uint4*>(xr + 8 * MT_XS);
        const uint4 h1 = *reinterpret_cast<const uint4*>(xr + 8 * MT_XS + 8);
        const uint32_t lo[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        const uint32_t hi[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t a[4] = {lo[2 * j], hi[2 * j], lo[2 * j + 1],
                                 hi[2 * j + 1]};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a, b[j][nt]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // acc[mt][nt]: c[0], c[1] at vocab v, v + 1 of row g; c[2], c[3] of g + 8.
  const bool pairs = (V & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int v = v_blk + warp * 32 + nt * 8 + 2 * t;
    if (v >= V) continue;
    const float s0 = s[v], s1 = v + 1 < V ? s[v + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r >= mt_rows) continue;
        OutT* out = y + (size_t)(m0 + r) * V + v;
        const float o0 = acc[mt][nt][2 * h] * s0;
        const float o1 = acc[mt][nt][2 * h + 1] * s1;
        if (pairs) {
          store_pair(out, o0, o1);
        } else {
          ft::store_out(out, o0);
          if (v + 1 < V) ft::store_out(out + 1, o1);
        }
      }
    }
  }
}

// Each launcher raises its kernel's dynamic shared memory limit on its
// first call (outside any CUDA-graph capture that later calls make).

// int8_matmul with its splits (grid.y) as one cluster per column tile.
template <int MT, bool VEC, typename OutT>
int launch_mm(dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
              const int8_t* q, const float* s, OutT* y, int M, int K,
              int N, int k_per_split) {
  return ft::launch_split_clusters<mm_kernel<MT, VEC, OutT>>(
      grid, THREADS, MmLayout<MT>::SMEM, st, x, q, s, y, M, K, N,
      k_per_split);
}

template <int MT, bool VEC, typename OutT>
int launch_mm_t(dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
                const int8_t* q, const float* s, OutT* y, int M,
                int D, int V) {
  static bool ready = false;
  constexpr int smem = MtLayout<MT>::SMEM;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        mm_t_kernel<MT, VEC, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  mm_t_kernel<MT, VEC, OutT><<<grid, THREADS, smem, st>>>(x, q, s, y, M, D,
                                                           V);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b))
          & 15) == 0;
}

int m_tiles(int M) {
  const int tiles = (M + 15) / 16;
  return tiles < MAX_MT ? tiles : MAX_MT;
}

template <typename OutT>
int dispatch_mm(int mt, bool vec, dim3 grid, cudaStream_t st,
                const __nv_bfloat16* x, const int8_t* q, const float* s,
                OutT* y, int M, int K, int N, int k_per_split) {
#define FT_MM(MT)                                                          \
  return vec ? launch_mm<MT, true>(grid, st, x, q, s, y, M, K, N,          \
                                   k_per_split)                            \
             : launch_mm<MT, false>(grid, st, x, q, s, y, M, K, N,         \
                                    k_per_split)
  switch (mt) {
    case 1: FT_MM(1);
    case 2: FT_MM(2);
    case 3: FT_MM(3);
    default: FT_MM(4);
  }
#undef FT_MM
}

template <typename OutT>
int dispatch_mm_t(int mt, bool vec, dim3 grid, cudaStream_t st,
                  const __nv_bfloat16* x, const int8_t* q, const float* s,
                  OutT* y, int M, int D, int V) {
#define FT_MT(MT)                                                          \
  return vec ? launch_mm_t<MT, true>(grid, st, x, q, s, y, M, D, V)        \
             : launch_mm_t<MT, false>(grid, st, x, q, s, y, M, D, V)
  switch (mt) {
    case 1: FT_MT(1);
    case 2: FT_MT(2);
    case 3: FT_MT(3);
    default: FT_MT(4);
  }
#undef FT_MT
}

}  // namespace

extern "C" {

// x [M, K] bf16, q [K, N] int8, s [N] f32 -> y [M, N] bf16 (f32 when
// out_f32), in ceil(K / k_per_split) <= 16 splits (k_per_split a multiple
// of 64).
int ft_int8_matmul(const void* x, const void* q, const void* s, void* y,
                   int M, int K, int N, int k_per_split, int out_f32,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = m_tiles(M);
  const int splits = K > 0 ? (K + k_per_split - 1) / k_per_split : 1;
  if (splits > MAX_SPLITS || k_per_split % MM_BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + MM_BN - 1) / MM_BN, splits,
                  (M + mt * 16 - 1) / (mt * 16));
  const bool vec = (N % 16) == 0 && (K % 8) == 0 && aligned16(x, q);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto qb = static_cast<const int8_t*>(q);
  auto sb = static_cast<const float*>(s);
  return out_f32 ? dispatch_mm(mt, vec, grid, st, xb, qb, sb,
                                static_cast<float*>(y), M, K, N, k_per_split)
                 : dispatch_mm(mt, vec, grid, st, xb, qb, sb,
                               static_cast<__nv_bfloat16*>(y), M, K, N,
                               k_per_split);
}

// x [M, D] bf16, q [V, D] int8, s [V] f32 -> y [M, V] bf16 (f32 when
// out_f32).
int ft_int8_matmul_t(const void* x, const void* q, const void* s, void* y,
                     int M, int D, int V, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = m_tiles(M);
  const dim3 grid((V + MT_BV - 1) / MT_BV, (M + mt * 16 - 1) / (mt * 16));
  const bool vec = (D % 16) == 0 && aligned16(x, q);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto qb = static_cast<const int8_t*>(q);
  auto sb = static_cast<const float*>(s);
  return out_f32 ? dispatch_mm_t(mt, vec, grid, st, xb, qb, sb,
                                  static_cast<float*>(y), M, D, V)
                 : dispatch_mm_t(mt, vec, grid, st, xb, qb, sb,
                                 static_cast<__nv_bfloat16*>(y), M, D, V);
}

}  // extern "C"
