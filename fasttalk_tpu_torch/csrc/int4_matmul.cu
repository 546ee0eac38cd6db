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
// Bound: the packed weight bytes plus the f32 group scales (1/G of the
// weights, 4 bytes each); x and y are KiB. For a Llama-3.2-1B decode step
// at M = 16 (112 calls, G = 128) that is 0.517 GB, 0.161 ms at 3.35 TB/s.
// The multiply-adds (2 M K N) go to the bf16 tensor cores, as in
// int8_matmul.cu, whose design this is with nibbles in place of bytes
// (the shared pieces are in mma_bf16.cuh):
// - A block owns 128 columns (32 a warp, four n8 tiles) and a K range:
//   split-K on grid.y, every split a whole number of 128-row stages. The
//   (at most 16) splits of a column tile run as one thread block cluster
//   and sum their f32 partial tiles in split order through distributed
//   shared memory: one launch a call, no workspace in device memory, and
//   the same bits on every call whatever the block order.
// - Packed weights (128 rows = 64 packed rows x 128 bytes a stage) and x
//   reach shared memory through a 4-stage ring of 16-byte cp.async copies;
//   ragged edges are zero-filled by the copy (plain loads when rows are not
//   16-byte aligned).
// - The packing already matches the mma's k pairs: B register b[0] of
//   m16n8k16 holds B[2t, 2t+1][g], two consecutive k of one column, which
//   is one packed byte (low nibble the lower k). With the k permutation of
//   int8_matmul (logical 2t, 2t+1, 2t+8, 2t+9 -> physical 4t .. 4t+3), a
//   lane's B bytes of a k-step are packed rows 2t and 2t+1, one 4-byte word
//   (4 columns) from each, byte c feeding n8 tile c.
// - Conversion without the I2F pipe: one byte permute puts byte c's two
//   nibbles in the two halves of a word, one LOP3 builds 128 + (n ^ 8) in
//   the mantissa of bf16 128, and one bf16x2 subtract of 136 leaves the
//   signed nibble, exactly. One bf16x2 multiply by the pair's scale
//   bf16(s) (both rows of a pair share a group: G is even), broadcast to
//   both halves, rounds q * bf16(s) once to bf16: the TPU kernel's and the
//   plain version's bits, on every weight.
// - A lane keeps its four columns' scales as bf16x2 words in registers and
//   re-reads them only when its rows enter a new group (G = 128: once per
//   8 k-steps).
// - Up to 4 m16 tiles (M <= 64) loop inside the block, so each weight tile
//   is read once for all of them; larger M takes more groups of 64 rows on
//   the grid (grid.z).
//
// ops/mma_layout.py writes the fragment mapping out in Python; the CPU
// tests check it against the plain version through numpy's m16n8k16.
//
// Every entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"

namespace {

using ft::cp_async16;
using ft::cp_async_commit;
using ft::cp_async_wait;
using ft::mma_bf16_16816;
using ft::pack4;

constexpr int THREADS = 128;   // 4 warps
constexpr int STAGES = 4;      // cp.async ring depth
constexpr int MAX_MT = 4;      // m16 tiles per block
constexpr int MAX_SPLITS = 16; // the splits of a column tile form a cluster
constexpr int BN = 128;        // columns a block
constexpr int BK = 128;        // weight rows a stage (64 packed rows)
constexpr int BP = BK / 2;     // packed rows a stage
constexpr int XS = BK + 16;    // x row stride in bf16 (288 bytes)

template <int MT>
struct Layout {
  static constexpr int W = BP * BN;                  // weight bytes a stage
  static constexpr int STAGE = W + MT * 16 * XS * 2;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(MT * 16 * (BN + 4) * 4 <= SMEM, "the sum tile fits the ring");
};

// Byte c of w as one bf16x2 word: its low nibble (the lower k) in the low
// half, its high nibble in the high half, each sign-extended, exactly.
// The permute puts byte c of w in byte 0 and byte c of w >> 4 in byte 2;
// the LOP3 keeps the two nibbles n and writes 0x43 | (n ^ 8) in each half,
// bf16 128 + (n ^ 8); subtracting bf16 136 leaves (n ^ 8) - 8, the signed
// value of n. ``c`` is a constant after unrolling.
__device__ __forceinline__ uint32_t s4_column_pair(uint32_t w, int c) {
  const uint32_t t = __byte_perm(w, w >> 4, c * 0x11 + (4 + c) * 0x1100);
  const uint32_t m = (t & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t bias = 0x43084308u;
  __nv_bfloat162 a, b;
  memcpy(&a, &m, 4);
  memcpy(&b, &bias, 4);
  const __nv_bfloat162 r = __hsub2(a, b);
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// q (a bf16x2 word of exact small integers) times the broadcast scale
// word, rounded once to bf16 (round to nearest even).
__device__ __forceinline__ uint32_t scale_pair(uint32_t q, uint32_t s2) {
  __nv_bfloat162 a, b;
  memcpy(&a, &q, 4);
  memcpy(&b, &s2, 4);
  const __nv_bfloat162 r = __hmul2(a, b);
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// bf16(v) in both halves of a word.
__device__ __forceinline__ uint32_t bf16_broadcast(float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  uint16_t u;
  memcpy(&u, &h, 2);
  return static_cast<uint32_t>(u) * 0x00010001u;
}

// The four scale words of this lane's columns n .. n + 3 for group grp
// (columns past N read as 0; the weights there are 0 as well).
__device__ __forceinline__ void load_scales(uint32_t (&sc)[4],
                                            const float* __restrict__ s,
                                            int grp, int n, int N) {
  const float* row = s + (size_t)grp * N + n;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    sc[c] = n + c < N ? bf16_broadcast(__ldg(row + c)) : 0u;
}

template <int MT, bool VEC>
__device__ __forceinline__ void load_stage(
    uint8_t* stage, const __nv_bfloat16* __restrict__ x,
    const uint8_t* __restrict__ q4, int K, int N, int m0, int mt_rows,
    int n_blk, int k0, int k_end) {
  const int tid = threadIdx.x;
  // Packed weights: BP rows x 8 chunks of 16 bytes, chunk j of packed row
  // p stored at j ^ (2 ((p / 2) % 4)), which keeps a warp's 4-byte B reads
  // on 32 distinct banks.
  const int p0 = k0 >> 1, p_end = k_end >> 1;
  for (int c = tid; c < BP * (BN / 16); c += THREADS) {
    const int r = c >> 3, j = c & 7;
    const int p = p0 + r, n = n_blk + 16 * j;
    uint8_t* dst = stage + r * BN + ((j ^ (((r >> 1) & 3) << 1)) << 4);
    const uint8_t* src = q4 + (size_t)p * N + n;
    if (VEC) {
      const bool in = p < p_end && n < N;   // N % 16 == 0: whole chunks
      cp_async16(dst, in ? src : q4, in ? 16 : 0);
    } else {
      const int cnt = p < p_end ? min(16, N - n) : 0;
      uint4 v;
      v.x = pack4(src, cnt);
      v.y = pack4(src + 4, cnt - 4);
      v.z = pack4(src + 8, cnt - 8);
      v.w = pack4(src + 12, cnt - 12);
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
  // x: mt_rows rows x BK bf16, 16 chunks of 8 a row (rows past M were
  // zeroed once).
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage + Layout<MT>::W);
  for (int c = tid; c < mt_rows * (BK / 8); c += THREADS) {
    const int r = c >> 4, j = c & 15;
    const int k = k0 + 8 * j;
    __nv_bfloat16* dst = xs + r * XS + 8 * j;
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

// G4: G % 4 == 0, so a lane's four rows of a k-step (4t .. 4t+3) share one
// group and one set of scale words serves both B registers. The G4
// instance is kept beside the general one because it is faster where it
// applies: 1.11 against 1.21 ms a Llama-3.2-1B decode step at M = 16,
// G = 128, on an H100 80GB HBM3 at 700 W (kernel_times.py, PERF.md).
template <int MT, bool VEC, bool G4>
__global__ void __launch_bounds__(THREADS)
mm4_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
           const uint8_t* __restrict__ q4,        // [K/2, N]
           const float* __restrict__ s,           // [K/G, N]
           __nv_bfloat16* __restrict__ y,         // [M, N]
           int M, int K, int N, int G, int k_per_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  using L = Layout<MT>;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_blk = blockIdx.x * BN;
  const int m0 = blockIdx.z * (MT * 16);
  const int mt_rows = min(MT * 16, M - m0);
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int iters = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int last_group = K / G - 1;

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][c][i] = 0.f;

  ft::zero_x_tail<THREADS, STAGES>(smem, L::STAGE, L::W, XS, MT * 16,
                                   mt_rows);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < iters)
      load_stage<MT, VEC>(smem + i * L::STAGE, x, q4, K, N, m0, mt_rows,
                          n_blk, k_begin + i * BK, k_end);
    cp_async_commit();
  }

  // This lane's B words: columns 32 warp + 4g .. +3 (chunk 2 warp + g / 4,
  // byte 4 (g % 4)) of packed rows 2t and 2t + 1 of each k-step, whose
  // swizzle term is 2t.
  const int b_off = ((((warp << 1) + (g >> 2)) ^ (t << 1)) << 4) + ((g & 3) << 2);
  const int n_lane = n_blk + warp * 32 + 4 * g;
  // Scale words of the two B registers (rows 4t + 2r, 4t + 2r + 1), and
  // the first weight row past the group they hold.
  uint32_t sc[2][4];
  int group_end[2] = {-1, -1};

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < iters)
      load_stage<MT, VEC>(smem + (nx % STAGES) * L::STAGE, x, q4, K, N, m0,
                          mt_rows, n_blk, k_begin + nx * BK, k_end);
    cp_async_commit();

    const uint8_t* wst = smem + (it % STAGES) * L::STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(wst + L::W);
    const int k_stage = k_begin + it * BK;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int row = k_stage + 16 * ks + 4 * t;
#pragma unroll
      for (int r = 0; r < (G4 ? 1 : 2); ++r) {
        if (row + 2 * r >= group_end[r]) {
          const int grp = min((row + 2 * r) / G, last_group);
          group_end[r] = (grp + 1) * G;
          load_scales(sc[r], s, grp, n_lane, N);
        }
      }
      uint32_t w[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(
            wst + (8 * ks + 2 * t + r) * BN + b_off);
      // n8 tile c takes byte c of the two words: packed row 2t (logical k
      // 2t, 2t+1) in b[c][0], packed row 2t + 1 (2t+8, 2t+9) in b[c][1].
      uint32_t b[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          b[c][r] = scale_pair(s4_column_pair(w[r], c), sc[G4 ? 0 : r][c]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xr = xs + (mt * 16 + g) * XS + 16 * ks + 4 * t;
        const uint2 lo = *reinterpret_cast<const uint2*>(xr);
        const uint2 hi = *reinterpret_cast<const uint2*>(xr + 8 * XS);
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_bf16_16816(acc[mt][c], a, b[c]);
      }
    }
  }

  ft::splitk_epilogue<MT, BN, THREADS, MAX_SPLITS>(smem, acc, y, nullptr, m0,
                                                   mt_rows, N, n_blk);
}

template <int MT, bool VEC, bool G4>
int launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
           const uint8_t* q4, const float* s, __nv_bfloat16* y, int M, int K,
           int N, int G, int k_per_split) {
  return ft::launch_split_clusters<mm4_kernel<MT, VEC, G4>>(
      grid, THREADS, Layout<MT>::SMEM, st, x, q4, s, y, M, K, N, G,
      k_per_split);
}

template <int MT>
int launch_mt(bool vec, bool g4, dim3 grid, cudaStream_t st,
              const __nv_bfloat16* x, const uint8_t* q4, const float* s,
              __nv_bfloat16* y, int M, int K, int N, int G, int k_per_split) {
  if (vec)
    return g4 ? launch<MT, true, true>(grid, st, x, q4, s, y, M, K, N, G,
                                       k_per_split)
              : launch<MT, true, false>(grid, st, x, q4, s, y, M, K, N, G,
                                        k_per_split);
  return g4 ? launch<MT, false, true>(grid, st, x, q4, s, y, M, K, N, G,
                                      k_per_split)
            : launch<MT, false, false>(grid, st, x, q4, s, y, M, K, N, G,
                                       k_per_split);
}

}  // namespace

extern "C" {

// x [M, K] bf16, q4 [K/2, N] uint8, s [K/G, N] f32 -> y [M, N] bf16, in
// ceil(K / k_per_split) <= 16 splits. K and G even, G | K, k_per_split a
// multiple of 128.
int ft_int4_matmul(const void* x, const void* q4, const void* s, void* y,
                   int M, int K, int N, int G, int k_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = K > 0 ? (K + k_per_split - 1) / k_per_split : 1;
  if (splits > MAX_SPLITS || k_per_split % BK != 0 || G <= 0 || G % 2
      || K % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (M + 15) / 16;
  const int mt = tiles < MAX_MT ? tiles : MAX_MT;
  const dim3 grid((N + BN - 1) / BN, splits, (M + mt * 16 - 1) / (mt * 16));
  const bool vec = (N % 16) == 0 && (K % 8) == 0
                   && ((reinterpret_cast<uintptr_t>(x)
                        | reinterpret_cast<uintptr_t>(q4)) & 15) == 0;
  const bool g4 = (G % 4) == 0;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto qb = static_cast<const uint8_t*>(q4);
  auto sb = static_cast<const float*>(s);
  auto yb = static_cast<__nv_bfloat16*>(y);
  switch (mt) {
    case 1: return launch_mt<1>(vec, g4, grid, st, xb, qb, sb, yb, M, K, N, G,
                                k_per_split);
    case 2: return launch_mt<2>(vec, g4, grid, st, xb, qb, sb, yb, M, K, N, G,
                                k_per_split);
    case 3: return launch_mt<3>(vec, g4, grid, st, xb, qb, sb, yb, M, K, N, G,
                                k_per_split);
    default: return launch_mt<4>(vec, g4, grid, st, xb, qb, sb, yb, M, K, N,
                                 G, k_per_split);
  }
}

}  // extern "C"
