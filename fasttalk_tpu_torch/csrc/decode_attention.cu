// Batched GQA decode attention over the KV cache for Hopper (sm_90a), bound
// to Python through a plain C interface (ctypes; ops/cuda_attention.py).
// One templated kernel covers the four tiers: dense or paged rows, bf16 or
// int8 rows with f32 row scales.
//
// Replaces the Pallas TPU kernels of fasttalk_tpu/ops/pallas_attention.py:
// decode_attend (:153, body _decode_kernel :62), both its bf16 and its
// int8-scale tier (k_scale/v_scale [B, S, G]), and decode_attend_paged
// (:249, _paged_decode_kernel :235), which runs the same recurrence over a
// flat row pool read through a block table. q [B, T, Nq, D] bf16; lengths[B]
// = keys visible to the block's LAST query, so query t of a T-block sees
// length - (T - 1) + t keys (in-block causality). Online softmax in f32.
//
// Row addressing (the only difference between the layouts):
// - dense: k/v [B, S, Nkv, D] with any batch stride; key j of slot b is row
//   j of slot b;
// - paged: k/v are the pool [P, Nkv, D]; key j of slot b is pool row
//   tables[b, j / bs] * bs + j % bs (64-bit), the slot's keys end at
//   nb * bs.
// Int8 rows carry f32 scales per row (granule SG = 1) or per row and KV head
// (SG = Nkv): dense [B, S, SG] with a batch stride, paged [P, SG]. The key
// scale multiplies the f32 score, the value scale the probability.
//
// Bound: the bytes of each slot's live K/V rows (plus their scales); q and
// the output are KiB. Design (flash-decoding on the tensor cores):
// - The key axis is split. A slot's live keys are cut into 64-key chunks;
//   block z of the `splits` blocks of a (KV head, slot, group of 16 query
//   rows) takes chunks z, z + splits, z + 2 splits, ..., so a long slot
//   spreads over all of its blocks while the blocks of short slots finish
//   at once; the grid is (Nkv x row groups, B, splits) whatever the
//   lengths (no host read of them, so a CUDA graph can hold the call).
//   The wrapper picks `splits` so the grid is one wave of resident blocks
//   (ft_decode_attend_resident): more splits than that only add blocks
//   that wait, each with its own fixed cost.
// - In a block, warp w takes the 16 keys 16w .. 16w + 15 of each chunk.
//   Each warp stages its own K/V tiles (and int8 scales) through a 3-stage
//   cp.async ring of its own, so the key loop has no block barrier; keys
//   past the slot's length are zero-filled by the copy; for the paged
//   tiers each key's pool row comes through the table.
// - QK^T on mma.sync m16n8k16 (bf16, f32 accumulators): the block's query
//   rows (T*G of them, at most 16, zero rows past R) are the m16 A tile,
//   held in registers for the whole loop; a tile's 16 K rows, D
//   contiguous, are B in "col" layout as they lie (int8 pairs converted
//   exactly on the way, mma_bf16.cuh). Scores are scaled (softmax scale,
//   int8 key scale) and masked in f32.
// - Online softmax state (m, l) in f32 per warp and row; the score
//   fragment is the P fragment of the next mma as it lies in registers.
//   P.V on mma.sync with V^T from shared memory through ldmatrix.trans
//   (int8 V converted to a bf16 tile first). P is split into bf16 hi + lo
//   (two mmas), so P.V keeps about 16 bits of each probability, as the TPU
//   kernel's f32 p @ v does to within the 1% check.
// - The warps' states merge in warp order in shared memory; the splits of
//   a (head, slot, row group) run as one thread block cluster and combine
//   in split order through distributed shared memory, each block writing
//   1/splits of the outputs: one launch a call, no workspace in device
//   memory, and the same bits on every call whatever the block order.
//
// ops/mma_layout.py writes the fragment mappings and the split combine out
// in Python; the CPU tests check them against the plain versions.
//
// Each entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <cooperative_groups.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using ft::cp_async16;
using ft::cp_async_commit;
using ft::cp_async_wait;
using ft::mma_bf16_16816;

constexpr int NW = 4;             // warps per block
constexpr int THREADS = NW * 32;
constexpr int TILE = 16;          // keys a warp takes from each chunk
constexpr int CHUNK = NW * TILE;  // keys a block takes at a time
constexpr int STAGES = 3;         // per-warp cp.async ring depth
constexpr int MAX_SPLITS = 8;     // a portable cluster
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;   // [B, T, Nkv, G, D]
  const void* k;            // dense [B, S, Nkv, D] (batch stride kv_bstride)
  const void* v;            //   or paged pool [P, Nkv, D]
  const float* ks;          // int8 only: dense [B, S, SG] (batch stride
  const float* vs;          //   s_bstride) or paged [P, SG]
  const int* lengths;       // [B]
  const int* tables;        // paged only: [B, nb]
  __nv_bfloat16* o;         // like q
  int T, G, Nkv, D;
  int S;                    // keys addressable per slot (paged: nb * bs)
  int SG;                   // scale granule: 1 or Nkv
  int nb, bs;               // paged: table width, block size
  long long kv_bstride, s_bstride;
  float scale_log2;         // log2(e) / sqrt(D)
};

// Shared-memory layout of one instance: DP = D padded to 16 DK elements,
// E the row element's size. Row strides carry 16 bytes of padding, which
// keeps a warp's fragment reads and ldmatrix rows on distinct banks.
template <int DK, int E>
struct Smem {
  static constexpr int DP = 16 * DK;
  static constexpr int QS = DP * 2 + 16;        // bytes of a bf16 row
  static constexpr int RS = DP * E + 16;        // bytes of a K/V tile row
  static constexpr int TILE_B = TILE * RS;
  static constexpr int STAGE = 2 * TILE_B + 2 * TILE * 4;   // K, V, scales
  static constexpr int VB = E == 1 ? TILE * QS : 0;         // bf16 V (int8)
  static constexpr int WARP_B = STAGES * STAGE + VB;
  static constexpr int Q_B = 16 * QS;
  static constexpr int RING = NW * WARP_B;
  static constexpr int STATE = 32 + 16 * DP;    // floats: m, l, acc[16][DP]
  static constexpr int MERGE = (NW + 1) * STATE * 4;
  static constexpr int BYTES = Q_B + (RING > MERGE ? RING : MERGE);
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

// Four 8x8 b16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8, and r[i] receives matrix i's elements [2t, 2t+1][g].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// (a, b) as a bf16 pair hi and the bf16 pair of what hi leaves out.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  memcpy(&hi, &h, 4);
  lo = ft::bf16x2_rn(a - hf.x, b - hf.y);
}

// The B word of K row `row` at element d, d + 1 of a tile.
template <int E>
__device__ __forceinline__ uint32_t k_pair(const uint8_t* tile, int rs,
                                           int row, int d) {
  if (E == 2)
    return *reinterpret_cast<const uint32_t*>(tile + row * rs + 2 * d);
  const uint32_t w = *reinterpret_cast<const uint16_t*>(tile + row * rs + d);
  return ft::s8pair_to_bf16x2(__byte_perm(w, 0u, 0x4140));
}

// Start the copies of one warp's tile: keys j0 .. j0 + 15 of the slot, K
// and V rows (D real elements, zero-filled to DP and past n_keys), and
// for int8 their scales. Lane l looks up the row of key l % 16 (through
// the table when paged: all 16 lookups in flight at once) and hands it to
// the lanes that copy that key's chunks.
template <int DK, int E, bool PAGED>
__device__ __forceinline__ void load_tile(uint8_t* st, const Args& a,
                                          const uint8_t* kb,
                                          const uint8_t* vb, long long s_base,
                                          const int* tab, int j0, int n_keys,
                                          int lane) {
  using L = Smem<DK, E>;
  constexpr int CH = L::DP * E / 16;          // 16-byte chunks of a row
  const int real = a.D * E / 16;
  const long long row_bytes = (long long)a.Nkv * a.D * E;
  const int jl = j0 + (lane & 15);
  long long my_row = 0;
  if (jl < n_keys)
    my_row = PAGED ? (long long)tab[jl / a.bs] * a.bs + jl % a.bs : jl;
#pragma unroll
  for (int base = 0; base < TILE * CH; base += 32) {
    const int i = base + lane;
    const int r = (i / CH) & (TILE - 1), c = i % CH;
    const long long row = __shfl_sync(0xffffffffu, my_row, r);
    if (i < TILE * CH) {
      const bool in = j0 + r < n_keys && c < real;
      const long long off = row * row_bytes + 16 * c;
      cp_async16(st + r * L::RS + 16 * c, in ? kb + off : kb, in ? 16 : 0);
      cp_async16(st + L::TILE_B + r * L::RS + 16 * c, in ? vb + off : vb,
                 in ? 16 : 0);
    }
  }
  if (E == 1) {
    const bool in = jl < n_keys;
    const float* src = (lane < 16 ? a.ks : a.vs) + s_base + my_row * a.SG;
    cp_async4(st + 2 * L::TILE_B + 4 * lane, in ? src : a.ks, in ? 4 : 0);
  }
}

template <int DK, int E, bool PAGED>
__global__ void __launch_bounds__(THREADS) attend_kernel(const Args a) {
  using L = Smem<DK, E>;
  constexpr int DP = L::DP;
  constexpr int ND = 2 * DK;          // n8 tiles of the output's D
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* qs = smem;
  uint8_t* ring = smem + L::Q_B;

  const int nkv = a.Nkv;
  const int h = blockIdx.x % nkv;
  const int r0 = (blockIdx.x / nkv) * 16;    // first query row of the block
  const int b = blockIdx.y;
  const int z = blockIdx.z, splits = gridDim.z;
  const int R = min(16, a.T * a.G - r0);     // query rows of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // Query rows in shared memory as bf16, rows past R and columns past D 0.
  for (int i = tid; i < 16 * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    __nv_bfloat16 val = __float2bfloat16(0.f);
    if (r < R && d < a.D) {
      const int tq = (r0 + r) / a.G, gq = (r0 + r) % a.G;
      val = a.q[((((long long)b * a.T + tq) * nkv + h) * a.G + gq) * a.D + d];
    }
    reinterpret_cast<__nv_bfloat16*>(qs + r * L::QS)[d] = val;
  }

  const int length = a.lengths[b];
  const int n_keys = max(0, min(length, a.S));
  // Keys visible to this lane's rows g and g + 8.
  int horizon[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    horizon[hh] = length - (a.T - 1) + (r0 + g + 8 * hh) / a.G;
  const long long kv_base = ((PAGED ? 0 : b * a.kv_bstride)
                             + (long long)h * a.D) * E;
  const uint8_t* kb = static_cast<const uint8_t*>(a.k) + kv_base;
  const uint8_t* vb = static_cast<const uint8_t*>(a.v) + kv_base;
  const long long s_base = (PAGED ? 0 : b * a.s_bstride) + (a.SG > 1 ? h : 0);
  const int* tab = PAGED ? a.tables + (long long)b * a.nb : nullptr;

  // This warp's tiles: keys (z + i splits) CHUNK + 16 warp, i = 0, 1, ...
  const int first = z * CHUNK + TILE * warp;
  const int stride = splits * CHUNK;
  const int n_tiles = first < n_keys ? (n_keys - first + stride - 1) / stride
                                     : 0;
  uint8_t* wring = ring + warp * L::WARP_B;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles)
      load_tile<DK, E, PAGED>(wring + i * L::STAGE, a, kb, vb, s_base, tab,
                              first + i * stride, n_keys, lane);
    cp_async_commit();
  }
  __syncthreads();

  // A fragments of the query rows, one per k-step of D.
  uint32_t qa[DK][4];
#pragma unroll
  for (int kd = 0; kd < DK; ++kd) {
    const uint8_t* q0 = qs + g * L::QS + 2 * (16 * kd + 2 * t);
    qa[kd][0] = *reinterpret_cast<const uint32_t*>(q0);
    qa[kd][1] = *reinterpret_cast<const uint32_t*>(q0 + 8 * L::QS);
    qa[kd][2] = *reinterpret_cast<const uint32_t*>(q0 + 16);
    qa[kd][3] = *reinterpret_cast<const uint32_t*>(q0 + 8 * L::QS + 16);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    const int nx = it + STAGES - 1;
    if (nx < n_tiles)
      load_tile<DK, E, PAGED>(wring + (nx % STAGES) * L::STAGE, a, kb, vb,
                              s_base, tab, first + nx * stride, n_keys, lane);
    cp_async_commit();

    const uint8_t* st = wring + (it % STAGES) * L::STAGE;
    const float* scl = reinterpret_cast<const float*>(st + 2 * L::TILE_B);
    const int j0 = first + it * stride;

    // Scores of rows g, g + 8 against keys 8 nt + 2t, 8 nt + 2t + 1.
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DK; ++kd) {
        const uint32_t bk[2] = {
            k_pair<E>(st, L::RS, 8 * nt + g, 16 * kd + 2 * t),
            k_pair<E>(st, L::RS, 8 * nt + g, 16 * kd + 2 * t + 8)};
        mma_bf16_16816(s[nt], qa[kd], bk);
      }
    }
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = 8 * nt + 2 * t + (i & 1);
        const int j = j0 + kc;
        float v = s[nt][i] * a.scale_log2;
        if (E == 1) v *= scl[kc];
        v = (j < n_keys && j < horizon[i >> 1]) ? v : NEG_INF;
        s[nt][i] = v;
        tmax[i >> 1] = fmaxf(tmax[i >> 1], v);
      }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
      const float m_new = fmaxf(m[hh], tmax[hh]);
      corr[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }
    // P (times the int8 value scale) as the A fragment of P.V: tile nt's
    // accumulators (keys 8 nt + 2t, +1 of rows g and g + 8) are A's k pair
    // 2t, 2t+1 (nt = 0) or 2t+8, 2t+9 (nt = 1), as they lie.
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float p0 = exp2f(s[nt][2 * hh] - m[hh]);
        float p1 = exp2f(s[nt][2 * hh + 1] - m[hh]);
        l[hh] += p0 + p1;
        if (E == 1) {
          const float* vsc = scl + TILE;
          p0 *= vsc[8 * nt + 2 * t];
          p1 *= vsc[8 * nt + 2 * t + 1];
        }
        split_bf16x2(p0, p1, ph[2 * nt + hh], pl[2 * nt + hh]);
      }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nd][i] *= corr[i >> 1];

    // V^T fragments: a bf16 V tile (int8 rows converted first), read by
    // ldmatrix.trans two n8 tiles of D at a time.
    const uint8_t* vt = st + L::TILE_B;
    int vrs = L::RS;
    if (E == 1) {
      uint8_t* vbf = wring + STAGES * L::STAGE;
      constexpr int CH = DP / 16;
      for (int i = lane; i < TILE * CH; i += 32) {
        const int r = i / CH, c = i % CH;
        const uint4 w = *reinterpret_cast<const uint4*>(vt + r * L::RS + 16 * c);
        uint4 o0, o1;
        ft::s8x4_to_bf16x4(w.x, o0.x, o0.y);
        ft::s8x4_to_bf16x4(w.y, o0.z, o0.w);
        ft::s8x4_to_bf16x4(w.z, o1.x, o1.y);
        ft::s8x4_to_bf16x4(w.w, o1.z, o1.w);
        uint4* dst = reinterpret_cast<uint4*>(vbf + r * L::QS + 32 * c);
        dst[0] = o0;
        dst[1] = o1;
      }
      __syncwarp();
      vt = vbf;
      vrs = L::QS;
    }
    const int mi = lane >> 3;
    const uint8_t* vrow = vt + ((mi & 1) * 8 + (lane & 7)) * vrs
                          + 2 * 8 * (mi >> 1);
#pragma unroll
    for (int dp = 0; dp < DK; ++dp) {
      uint32_t r4[4];
      ldmatrix_x4_trans(r4, vrow + 2 * 16 * dp);
      const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
      mma_bf16_16816(acc[2 * dp], ph, b0);
      mma_bf16_16816(acc[2 * dp], pl, b0);
      mma_bf16_16816(acc[2 * dp + 1], ph, b1);
      mma_bf16_16816(acc[2 * dp + 1], pl, b1);
    }
    __syncwarp();   // the V tile (and bf16 copy) is read before reuse
  }

  // Row sums of the lane partials (the 4 lanes of a row).
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  cp_async_wait<0>();
  __syncthreads();
  // Each warp's state (m[16], l[16], acc[16][DP]) to shared memory.
  float* states = reinterpret_cast<float*>(ring);
  float* mine = states + warp * L::STATE;
  if (t == 0) {
    mine[g] = m[0];
    mine[g + 8] = m[1];
    mine[16 + g] = l[0];
    mine[16 + g + 8] = l[1];
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(mine + 32 + (g + 8 * hh) * DP + 8 * nd
                                 + 2 * t) =
          make_float2(acc[nd][2 * hh], acc[nd][2 * hh + 1]);
  __syncthreads();
  // The block's state: the warps merged in warp order.
  float* part = states + NW * L::STATE;
  for (int i = tid; i < R * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, states[w * L::STATE + r]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* sw = states + w * L::STATE;
      const float f = exp2f(sw[r] - mx);
      lsum += sw[16 + r] * f;
      asum += sw[32 + r * DP + d] * f;
    }
    part[32 + i] = asum;
    if (d == 0) {
      part[r] = mx;
      part[16 + r] = lsum;
    }
  }

  // The splits' states combined in split order; block z writes outputs
  // z, z + splits, ... of the R x D of its (head, slot, row group).
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1)
    cluster.sync();
  else
    __syncthreads();
  for (int i = z * THREADS + tid; i < R * a.D; i += splits * THREADS) {
    const int r = i / a.D, d = i % a.D;
    const float* src[MAX_SPLITS];
#pragma unroll
    for (int u = 0; u < MAX_SPLITS; ++u)
      src[u] = u < splits ? (splits > 1 ? cluster.map_shared_rank(part, u)
                                        : part)
                          : part;
    float mx = NEG_INF;
#pragma unroll
    for (int u = 0; u < MAX_SPLITS; ++u)
      if (u < splits) mx = fmaxf(mx, src[u][r]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_SPLITS; ++u)
      if (u < splits) {
        const float f = exp2f(src[u][r] - mx);
        lsum += src[u][16 + r] * f;
        asum += src[u][32 + r * DP + d] * f;
      }
    const int tq = (r0 + r) / a.G, gq = (r0 + r) % a.G;
    a.o[((((long long)b * a.T + tq) * nkv + h) * a.G + gq) * a.D + d] =
        __float2bfloat16(asum / fmaxf(lsum, 1e-30f));
  }
  if (splits > 1) cluster.sync();   // keep `part` until every reader is done
}

// Raises the instance's dynamic shared memory limit once (outside any
// CUDA-graph capture that later calls make).
template <int DK, int E, bool PAGED>
cudaError_t prepare() {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        attend_kernel<DK, E, PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<DK, E>::BYTES);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  return cudaSuccess;
}

template <int DK, int E, bool PAGED>
cudaError_t launch_k(const Args& a, int B, int splits, cudaStream_t st) {
  const cudaError_t ready = prepare<DK, E, PAGED>();
  if (ready != cudaSuccess) return ready;
  const int groups = (a.T * a.G + 15) / 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Nkv * groups, B, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Smem<DK, E>::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, attend_kernel<DK, E, PAGED>,
                                             a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <int DK, int E, bool PAGED>
cudaError_t resident_k(int* blocks) {
  const cudaError_t ready = prepare<DK, E, PAGED>();
  if (ready != cudaSuccess) return ready;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attend_kernel<DK, E, PAGED>, THREADS, Smem<DK, E>::BYTES);
}

template <int E, bool PAGED>
cudaError_t launch_d(const Args& a, int B, int splits, cudaStream_t st) {
  if (a.D <= 16) return launch_k<1, E, PAGED>(a, B, splits, st);
  if (a.D <= 32) return launch_k<2, E, PAGED>(a, B, splits, st);
  if (a.D <= 64) return launch_k<4, E, PAGED>(a, B, splits, st);
  return launch_k<8, E, PAGED>(a, B, splits, st);
}

template <int E, bool PAGED>
cudaError_t resident_d(int D, int* blocks) {
  if (D <= 16) return resident_k<1, E, PAGED>(blocks);
  if (D <= 32) return resident_k<2, E, PAGED>(blocks);
  if (D <= 64) return resident_k<4, E, PAGED>(blocks);
  return resident_k<8, E, PAGED>(blocks);
}

template <bool PAGED>
int launch(const Args& a, int B, int splits, void* stream) {
  if (B <= 0 || a.T <= 0 || a.G <= 0 || a.Nkv <= 0 || a.D <= 0 || a.D > 128
      || splits <= 0 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = a.ks != nullptr
                              ? launch_d<1, PAGED>(a, B, splits, st)
                              : launch_d<2, PAGED>(a, B, splits, st);
  return static_cast<int>(err);
}

Args make_args(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* lengths, void* o, int T, int G,
               int Nkv, int D, int SG) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.lengths = static_cast<const int*>(lengths);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.T = T;
  a.G = G;
  a.Nkv = Nkv;
  a.D = D;
  a.SG = SG;
  a.scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  return a;
}

}  // namespace

extern "C" {

// q/o [B, T, Nkv*G, D] bf16 contiguous; k/v [B, S, Nkv, D] with batch stride
// kv_bstride elements and contiguous inner dims, bf16 when ks is null, else
// int8 with f32 scales ks/vs [B, S, SG] (batch stride s_bstride, contiguous
// inner dims); lengths [B] int32; the key axis in `splits` (<= 8) parts.
// The wrapper checks D <= 128, D a multiple of 16 bytes' elements, and
// 16-byte-aligned rows.
int ft_decode_attend(const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* lengths,
                     void* o, int B, int T, int G, int Nkv, int D, int S,
                     long long kv_bstride, long long s_bstride, int SG,
                     int splits, void* stream) {
  Args a = make_args(q, k, v, ks, vs, lengths, o, T, G, Nkv, D, SG);
  a.S = S;
  a.kv_bstride = kv_bstride;
  a.s_bstride = s_bstride;
  return launch<false>(a, B, splits, stream);
}

// The same over a pool: k/v [P, Nkv, D] (bf16, or int8 with scales ks/vs
// [P, SG] f32), tables [B, nb] int32 pool block ids, block size bs; slot b's
// key j lives at pool row tables[b, j / bs] * bs + j % bs.
int ft_decode_attend_paged(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* lengths,
                           const void* tables, void* o, int B, int T, int G,
                           int Nkv, int D, int nb, int bs, int SG, int splits,
                           void* stream) {
  Args a = make_args(q, k, v, ks, vs, lengths, o, T, G, Nkv, D, SG);
  a.tables = static_cast<const int*>(tables);
  a.nb = nb;
  a.bs = bs;
  a.S = nb * bs;
  return launch<true>(a, B, splits, stream);
}

// Blocks of the instance for (int8, paged, D) that one SM holds at once
// (shared memory, registers), into *blocks: the wrapper sizes `splits` so
// that a call's grid is one wave.
int ft_decode_attend_resident(int int8, int paged, int D, int* blocks) {
  if (D <= 0 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (int8)
    err = paged ? resident_d<1, true>(D, blocks) : resident_d<1, false>(D, blocks);
  else
    err = paged ? resident_d<2, true>(D, blocks) : resident_d<2, false>(D, blocks);
  return static_cast<int>(err);
}

}  // extern "C"
