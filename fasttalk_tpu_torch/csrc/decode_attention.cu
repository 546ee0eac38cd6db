// Batched GQA decode attention over the dense bf16 KV cache, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes;
// ops/cuda_attention.py).
//
// Replaces the Pallas TPU kernel fasttalk_tpu/ops/pallas_attention.py
// decode_attend (:153, body _decode_kernel :62), bf16 K/V tier: q
// [B, T, Nq, D], k/v [B, S, Nkv, D] (cache layout, any batch stride),
// lengths[B] = keys visible to the block's LAST query; query t of a T-block
// sees length - (T - 1) + t keys (in-block causality). Online softmax in
// f32.
//
// Bound: the K/V bytes of each slot's live prefix (2 * length * Nkv * D *
// 2 bytes per layer); q and the output are KiB. Design:
// - one block per (KV head, slot); the block holds that head's T*G query
//   rows (4 at T=1 for Llama-3.2-1B) in shared memory as f32;
// - the key loop runs only to the slot's live length. The TPU kernel pruned
//   by revisiting a block index; here it is the loop bound;
// - 8 warps take 32-key tiles in turn. Scores: lane = key, each lane reads
//   its key's D-element row with 16-byte loads and dots it against every
//   query row (no shuffles). Softmax state (m, l, acc) stays in f32
//   registers per warp. P @ V: lane = head-dim element, so each value row is
//   one coalesced read by the warp;
// - the warps' states merge once at the end through shared memory, one warp
//   after another in warp order, so the output does not depend on timing.
//
// The entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;            // warps per block
constexpr int TILE = 32;         // keys per warp tile
constexpr float NEG_INF = -1e30f;

template <int MAXR, int DPL>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const __nv_bfloat16* __restrict__ q,   // [B, T, Nkv, G, D]
              const __nv_bfloat16* __restrict__ k,   // [B, S, Nkv, D] strided B
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ lengths,       // [B]
              __nv_bfloat16* __restrict__ o,         // like q
              int T, int G, int Nkv, int D, int S, long long kv_bstride,
              float scale) {
  constexpr int DMAX = DPL * 32;
  __shared__ float qs[MAXR][DMAX];
  __shared__ float ps[NW][MAXR][TILE];
  __shared__ float acc_s[MAXR][DMAX];
  __shared__ float m_s[NW][MAXR];
  __shared__ float l_s[NW][MAXR];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int R = T * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < R * D; i += NW * 32) {
    const int r = i / D, d = i % D;
    const int t = r / G, g = r % G;
    qs[r][d] = __bfloat162float(
        q[((((long long)b * T + t) * Nkv + h) * G + g) * D + d]);
    acc_s[r][d] = 0.f;
  }
  __syncthreads();

  const int length = lengths[b];
  const int n_keys = max(0, min(length, S));
  const long long row_stride = (long long)Nkv * D;
  const __nv_bfloat16* kb = k + (long long)b * kv_bstride + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * kv_bstride + (long long)h * D;

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
    if (j < n_keys) {
      const __nv_bfloat16* kr = kb + (long long)j * row_stride;
      for (int d0 = 0; d0 < D; d0 += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + d0);
        const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(kp[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < R) {
            float a = sc[r];
#pragma unroll
            for (int e = 0; e < 8; ++e) a = fmaf(qs[r][d0 + e], kf[e], a);
            sc[r] = a;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < R) {
        const int horizon = length - (T - 1) + r / G;
        const float s = (j < n_keys && j < horizon) ? sc[r] * scale : NEG_INF;
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
      const __nv_bfloat16* vr = vb + (long long)(tile * TILE + kk) * row_stride;
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? __bfloat162float(vr[d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          const float p = ps[warp][r][kk];
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
    const int t = r / G, g = r % G;
    o[((((long long)b * T + t) * Nkv + h) * G + g) * D + d] =
        __float2bfloat16(acc_s[r][d] / fmaxf(lall, 1e-30f));
  }
}

template <int MAXR, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* o, int B, int T, int G, int Nkv,
                   int D, int S, long long kv_bstride, float scale,
                   cudaStream_t st) {
  const dim3 grid(Nkv, B);
  decode_kernel<MAXR, DPL><<<grid, NW * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(o), T, G, Nkv, D, S, kv_bstride, scale);
  return cudaGetLastError();
}

template <int MAXR>
cudaError_t launch_d(int dpl, const void* q, const void* k, const void* v,
                     const void* lengths, void* o, int B, int T, int G,
                     int Nkv, int D, int S, long long kv_bstride, float scale,
                     cudaStream_t st) {
  switch (dpl) {
    case 1: return launch<MAXR, 1>(q, k, v, lengths, o, B, T, G, Nkv, D, S, kv_bstride, scale, st);
    case 2: return launch<MAXR, 2>(q, k, v, lengths, o, B, T, G, Nkv, D, S, kv_bstride, scale, st);
    case 4: return launch<MAXR, 4>(q, k, v, lengths, o, B, T, G, Nkv, D, S, kv_bstride, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/o [B, T, Nkv*G, D] bf16 contiguous; k/v [B, S, Nkv, D] bf16 with batch
// stride kv_bstride elements and contiguous inner dims; lengths [B] int32.
// Requires T*G <= 16, D <= 128 and D % 8 == 0 (checked by the wrapper).
int ft_decode_attend(const void* q, const void* k, const void* v,
                     const void* lengths, void* o, int B, int T, int G,
                     int Nkv, int D, int S, long long kv_bstride,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int R = T * G;
  const int dpl = D <= 32 ? 1 : (D <= 64 ? 2 : 4);
  cudaError_t err;
  if (R <= 4)
    err = launch_d<4>(dpl, q, k, v, lengths, o, B, T, G, Nkv, D, S, kv_bstride, scale, st);
  else if (R <= 8)
    err = launch_d<8>(dpl, q, k, v, lengths, o, B, T, G, Nkv, D, S, kv_bstride, scale, st);
  else if (R <= 16)
    err = launch_d<16>(dpl, q, k, v, lengths, o, B, T, G, Nkv, D, S, kv_bstride, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
