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
// (SG = Nkv): dense [B, S, SG] with a batch stride, paged [P, SG]. The rows
// are loaded as int8 and scaled in f32 after the load: the score by the key
// row's scale, the probability by the value row's scale.
//
// Bound: the bytes of each slot's live K/V rows (plus their scales); q and
// the output are KiB. Design:
// - one block per (KV head, slot, group of 16 query rows): the block holds
//   up to 16 of the head's T*G query rows in shared memory as f32, so any T
//   runs (T*G > 16 re-reads the slot's rows once per group);
// - the key loop runs only to the slot's live length. The TPU kernel pruned
//   by revisiting a block index; here it is the loop bound;
// - 8 warps take 32-key tiles in turn. Scores: lane = key; each lane looks
//   up its own key's row (and, paged, its pool row through the table), reads
//   the D-element row with 16-byte loads (8 bf16 or 16 int8 per load) and
//   dots it against every query row (no shuffles). Softmax state (m, l, acc)
//   stays in f32 registers per warp. P @ V: lane = head-dim element, the
//   tile's row addresses come from shared memory, each value row is one
//   coalesced read by the warp;
// - the warps' states merge once at the end through shared memory, one warp
//   after another in warp order, so repeated calls give the same bits.
//
// Each entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;            // warps per block
constexpr int TILE = 32;         // keys per warp tile
constexpr float NEG_INF = -1e30f;

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
  float scale;
};

template <typename E> struct Elt;

template <> struct Elt<__nv_bfloat16> {
  static constexpr int PER16 = 8;   // elements per 16-byte load
  __device__ static void unpack(const uint4& raw, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(p[e]);
      f[2 * e] = x.x;
      f[2 * e + 1] = x.y;
    }
  }
  __device__ static float one(const __nv_bfloat16* p, int d) {
    return __bfloat162float(p[d]);
  }
};

// int8 -> f32 without the int-to-float converter (a quarter-rate unit): the
// byte, biased to unsigned, becomes the low mantissa byte of 2^23 (one byte
// permute), and one f32 subtraction of 2^23 + 128 leaves its signed value
// exactly.
__device__ __forceinline__ float i8_to_f32(uint32_t biased_word, int byte) {
  return __uint_as_float(__byte_perm(biased_word, 0x4B000000u, 0x7650 + byte))
         - 8388736.0f;
}

template <> struct Elt<int8_t> {
  static constexpr int PER16 = 16;
  __device__ static void unpack(const uint4& raw, float* f) {
    const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                           raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = i8_to_f32(w[e / 4], e % 4);
  }
  __device__ static float one(const int8_t* p, int d) {
    return i8_to_f32(static_cast<uint32_t>(static_cast<uint8_t>(p[d])) ^ 0x80u,
                     0);
  }
};

template <typename E, bool PAGED, int MAXR, int DPL>
__global__ void __launch_bounds__(NW * 32) decode_kernel(const Args a) {
  constexpr bool SCALED = sizeof(E) == 1;
  constexpr int DMAX = DPL * 32;
  constexpr int PER = Elt<E>::PER16;
  __shared__ float qs[MAXR][DMAX];
  __shared__ float ps[NW][MAXR][TILE];
  __shared__ long long rows_s[NW][TILE];   // row of each key of a warp's tile
  __shared__ float vsc_s[NW][TILE];        // its value scale
  __shared__ float acc_s[MAXR][DMAX];
  __shared__ float m_s[NW][MAXR];
  __shared__ float l_s[NW][MAXR];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * MAXR;          // first query row of this block
  const int R = min(MAXR, a.T * a.G - r0);   // query rows of this block
  const int D = a.D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < R * D; i += NW * 32) {
    const int r = i / D, d = i % D;
    const int t = (r0 + r) / a.G, g = (r0 + r) % a.G;
    qs[r][d] = __bfloat162float(
        a.q[((((long long)b * a.T + t) * a.Nkv + h) * a.G + g) * D + d]);
    acc_s[r][d] = 0.f;
  }
  __syncthreads();

  const int length = a.lengths[b];
  const int n_keys = max(0, min(length, a.S));
  const long long row_stride = (long long)a.Nkv * D;
  const long long kv_base = (PAGED ? 0 : b * a.kv_bstride) + (long long)h * D;
  const E* kb = static_cast<const E*>(a.k) + kv_base;
  const E* vb = static_cast<const E*>(a.v) + kv_base;
  const long long s_base = (PAGED ? 0 : b * a.s_bstride) + (a.SG > 1 ? h : 0);
  const int* tab = PAGED ? a.tables + (long long)b * a.nb : nullptr;

  float m[MAXR], l[MAXR], acc[MAXR][DPL];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int n_tiles = (n_keys + TILE - 1) / TILE;
  for (int tile = warp; tile < n_tiles; tile += NW) {
    const int j = tile * TILE + lane;
    float sc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) sc[r] = 0.f;
    long long row = 0;
    float kscale = 1.f, vscale = 1.f;
    if (j < n_keys) {
      row = PAGED ? (long long)tab[j / a.bs] * a.bs + j % a.bs : j;
      if (SCALED) {
        kscale = a.ks[s_base + row * a.SG];
        vscale = a.vs[s_base + row * a.SG];
      }
      const E* kr = kb + row * row_stride;
      for (int d0 = 0; d0 < D; d0 += PER) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + d0);
        float kf[PER];
        Elt<E>::unpack(raw, kf);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < R) {
            float acc_r = sc[r];
#pragma unroll
            for (int e = 0; e < PER; ++e) acc_r = fmaf(qs[r][d0 + e], kf[e], acc_r);
            sc[r] = acc_r;
          }
        }
      }
    }
    rows_s[warp][lane] = row;
    vsc_s[warp][lane] = vscale;
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < R) {
        const int horizon = length - (a.T - 1) + (r0 + r) / a.G;
        const float s = (j < n_keys && j < horizon)
                            ? sc[r] * kscale * a.scale : NEG_INF;
        float tmax = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m[r], tmax);
        const float corr = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = l[r] * corr + p;
        m[r] = m_new;
        ps[warp][r][lane] = p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      }
    }
    __syncwarp();
    const int kn = min(TILE, n_keys - tile * TILE);
#pragma unroll 8
    for (int kk = 0; kk < kn; ++kk) {
      const E* vr = vb + rows_s[warp][kk] * row_stride;
      const float vsk = vsc_s[warp][kk];
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? Elt<E>::one(vr, d) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          const float p = SCALED ? ps[warp][r][kk] * vsk : ps[warp][r][kk];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

  // Merge the warps' (m, l, acc): l is a per-lane partial until here.
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < R) {
      float lsum = l[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
      if (lane == 0) {
        m_s[warp][r] = m[r];
        l_s[warp][r] = lsum;
      }
    }
  }
  __syncthreads();
  // Fold each warp's accumulator into acc_s in warp order: a fixed order of
  // f32 additions, where atomics would add in whatever order warps arrive.
  for (int w = 0; w < NW; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          float mall = NEG_INF;
#pragma unroll
          for (int u = 0; u < NW; ++u) mall = fmaxf(mall, m_s[u][r]);
          const float f = expf(m[r] - mall);
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) acc_s[r][d] += acc[r][i] * f;
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < R * D; i += NW * 32) {
    const int r = i / D, d = i % D;
    float mall = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mall = fmaxf(mall, m_s[w][r]);
    float lall = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) lall += l_s[w][r] * expf(m_s[w][r] - mall);
    const int t = (r0 + r) / a.G, g = (r0 + r) % a.G;
    a.o[((((long long)b * a.T + t) * a.Nkv + h) * a.G + g) * D + d] =
        __float2bfloat16(acc_s[r][d] / fmaxf(lall, 1e-30f));
  }
}

template <typename E, bool PAGED, int MAXR>
cudaError_t launch_d(const Args& a, int B, cudaStream_t st) {
  const int rows = a.T * a.G;
  const dim3 grid(a.Nkv, B, (rows + MAXR - 1) / MAXR);
  const int dpl = a.D <= 32 ? 1 : (a.D <= 64 ? 2 : 4);
  switch (dpl) {
    case 1: decode_kernel<E, PAGED, MAXR, 1><<<grid, NW * 32, 0, st>>>(a); break;
    case 2: decode_kernel<E, PAGED, MAXR, 2><<<grid, NW * 32, 0, st>>>(a); break;
    default: decode_kernel<E, PAGED, MAXR, 4><<<grid, NW * 32, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

template <typename E, bool PAGED>
cudaError_t launch_r(const Args& a, int B, cudaStream_t st) {
  const int rows = a.T * a.G;
  if (rows <= 4) return launch_d<E, PAGED, 4>(a, B, st);
  if (rows <= 8) return launch_d<E, PAGED, 8>(a, B, st);
  return launch_d<E, PAGED, 16>(a, B, st);
}

template <bool PAGED>
int launch(const Args& a, int B, void* stream) {
  if (B <= 0 || a.T <= 0 || a.G <= 0 || a.Nkv <= 0 || a.D <= 0 || a.D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = a.ks != nullptr ? launch_r<int8_t, PAGED>(a, B, st)
                                          : launch_r<__nv_bfloat16, PAGED>(a, B, st);
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
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  return a;
}

}  // namespace

extern "C" {

// q/o [B, T, Nkv*G, D] bf16 contiguous; k/v [B, S, Nkv, D] with batch stride
// kv_bstride elements and contiguous inner dims, bf16 when ks is null, else
// int8 with f32 scales ks/vs [B, S, SG] (batch stride s_bstride, contiguous
// inner dims); lengths [B] int32. The wrapper checks D <= 128, D a multiple
// of 16 bytes' elements, and 16-byte-aligned rows.
int ft_decode_attend(const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* lengths,
                     void* o, int B, int T, int G, int Nkv, int D, int S,
                     long long kv_bstride, long long s_bstride, int SG,
                     void* stream) {
  Args a = make_args(q, k, v, ks, vs, lengths, o, T, G, Nkv, D, SG);
  a.S = S;
  a.kv_bstride = kv_bstride;
  a.s_bstride = s_bstride;
  return launch<false>(a, B, stream);
}

// The same over a pool: k/v [P, Nkv, D] (bf16, or int8 with scales ks/vs
// [P, SG] f32), tables [B, nb] int32 pool block ids, block size bs; slot b's
// key j lives at pool row tables[b, j / bs] * bs + j % bs.
int ft_decode_attend_paged(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* lengths,
                           const void* tables, void* o, int B, int T, int G,
                           int Nkv, int D, int nb, int bs, int SG,
                           void* stream) {
  Args a = make_args(q, k, v, ks, vs, lengths, o, T, G, Nkv, D, SG);
  a.tables = static_cast<const int*>(tables);
  a.nb = nb;
  a.bs = bs;
  a.S = nb * bs;
  return launch<true>(a, B, stream);
}

}  // extern "C"
