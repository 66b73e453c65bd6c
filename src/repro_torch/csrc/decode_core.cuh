// The decode core shared by the dense and the paged decode kernels
// (decode_attention.cu, paged_decode_attention.cu): one query token per
// sequence against its keys, split across blocks (flash-decoding).
//
// The work is about 2 * G operations per byte of K/V, and every model on
// the serving path has H = KV (G = 1), so the bound is the K/V bytes over
// the card's memory rate, far below the tensor cores' ~295 operations per
// byte: the core runs on the CUDA cores in fp32 and spends its design on
// keeping bytes in flight.
//
//   - Split-KV. A block owns one (kv head, sequence, group of up to R query
//     rows, split). Split i of n covers the sequence's keys
//     [i * chunk, min((i + 1) * chunk, len)); the host picks n and chunk (a
//     multiple of the key tile) from shapes alone, about one block per SM
//     where the keys allow (kernels/decode_attention.py `decode_splits`):
//     one sequence of 32 kv heads gets 4 splits, four sequences none, since
//     on the card every further split costs more (a merge, a block's start)
//     than the balance it buys. A split past a short sequence's end folds
//     nothing and reports an empty state.
//   - K/V tiles of KT = 64 keys arrive in the input type through 16-byte
//     cp.async into a ring of STAGES = 3 (tiles j + 1 and j + 2 load while
//     tile j is computed); keys past the split's end are zero-filled (source
//     size 0), so no garbage value row ever meets a zero probability. A
//     thread copies whole 16-byte chunks whatever the compute mapping below,
//     so the loads stay 16 bytes wide at every head dim.
//   - Eight warps a block, so that one block on an SM still hides the
//     latency of its shuffles and exponentials.
//   - Scores by lane groups. A lane holds one 16-byte vector of a row (8
//     bf16 or 4 fp32 elements) and LANES = D * sizeof(T) / 16 lanes (rounded
//     up to a power of two) own one key: 16 at D 128 bf16, so a warp scores
//     two keys a step, reduced by 4 xor shuffles. D 80 bf16 is 10 vectors:
//     it takes groups of 16 lanes with 6 idle. The copies are unaffected
//     (whole chunks, above); only the CUDA-core work, a small share of the
//     time at ~2 operations per byte, runs on 10 of 16 lanes, and the
//     power-of-two group keeps the reduction a butterfly. Each lane group is
//     a key processor with its own online-softmax state; it folds its keys
//     of a tile in batches (one max and one rescale a batch). The query
//     rows sit in registers as fp32 in the same split.
//   - P.V. A lane accumulates its own vector's columns in fp32, reading V
//     from shared memory as 16-byte vectors.
//   - Merging. The block merges its key processors' states in a fixed order
//     through shared memory. With one split it writes the output; otherwise
//     it writes a partial (m, l, acc[D]) in fp32 to the workspace, and the
//     last block of the (kv head, sequence, row group) to arrive (an atomic
//     ticket) merges all partials in split order. So the merge needs no
//     second launch (one launch per call, and no gap between two kernels
//     inside a call that is itself only a few launch latencies long), and
//     two calls are bit-identical: which
//     block merges changes nothing, the order of the sums is fixed. The
//     merging block leaves its ticket at 0 for the next launch. The paged
//     decode's own token (its K/V are not in the pool yet) is merged last,
//     as the TPU kernel's finalize step does.
//
// Scores are q.k * (1 / sqrt(D)) with the scale rounded to fp32 and
// exponentiated by expf, in the units the plain version and the fp32 oracle
// use. Masked scores are NEG_INF = -1e30 and the denominator is floored at
// 1e-30, as in the TPU kernels. Any G works: rows past R go to further row
// groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace rt {
namespace dec {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KT = 64;       // keys per tile
constexpr int STAGES = 3;    // depth of the cp.async ring

// How a block of type T and head dim D maps keys onto lanes.
template <typename T, int D>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(T);     // elements in a 16-byte vector
  static constexpr int CH = D / VEC;                  // vectors in a row
  static constexpr int LANES = CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;  // lanes a key
  static constexpr int GROUPS = 32 / LANES;           // keys a warp scores at once
  static constexpr int NKP = WARPS * GROUPS;          // key processors in a block
  static constexpr int KPT = KT / NKP;                // keys a processor folds a tile
  static_assert(D % VEC == 0 && CH <= 32, "rows must be whole 16-byte vectors, at most 32");
  static_assert(KT % NKP == 0, "whole keys a processor");
};

// Floats of one softmax state of R rows: m[R], l[R], acc[R][D].
__host__ __device__ constexpr int state_floats(int R, int D) { return R * (D + 2); }

// Dynamic shared memory of a block: the K/V ring, reused for the key
// processors' states once the keys are folded; R scores against the own
// token and the merge flag; then `ids` page ids (paged decode only).
template <typename T, int D, int R>
__host__ __device__ constexpr size_t main_bytes() {
  constexpr size_t ring = (size_t)STAGES * 2 * KT * D * sizeof(T);
  constexpr size_t states = (size_t)Geo<T, D>::NKP * state_floats(R, D) * sizeof(float);
  return ring > states ? ring : states;
}
constexpr size_t MISC_BYTES = 64;    // s_self[R <= 8] and the merge flag
template <typename T, int D, int R>
__host__ __device__ constexpr size_t smem_bytes(int ids) {
  return main_bytes<T, D, R>() + MISC_BYTES + (size_t)ids * 4;
}

// 16 bytes at p as fp32.
__device__ __forceinline__ void load16(float (&out)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(float (&out)[4], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x;
  out[1] = u.y;
  out[2] = u.z;
  out[3] = u.w;
}

// Merge ns softmax states of nrows rows, laid out state_floats(R, D) apart
// from st, in the order s = 0, 1, ..., then one more key per row when s_self
// is given (score s_self[i], value row v_self). With o, write row i
// normalised to o + i * D; otherwise write the merged state to dst. GLOBAL:
// st is the workspace, written by other blocks, read past L1.
template <typename T, int D, int R, bool GLOBAL>
__device__ __forceinline__ void merge_states(const float* st, int ns, int nrows,
                                             const float* s_self, const T* __restrict__ v_self,
                                             T* __restrict__ o, float* __restrict__ dst) {
  constexpr int SS = state_floats(R, D);
  auto ld = [](const float* p) {
    if constexpr (GLOBAL) return __ldcg(p);
    else return *p;
  };
  for (int e = threadIdx.x; e < nrows * D; e += THREADS) {
    const int i = e / D, d = e % D;
    float m = s_self ? s_self[i] : NEG_INF;
    for (int s = 0; s < ns; ++s) m = fmaxf(m, ld(st + s * SS + i));
    float l = 0.f, a = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float c = expf(ld(st + s * SS + i) - m);
      l = fmaf(ld(st + s * SS + R + i), c, l);
      a = fmaf(ld(st + s * SS + 2 * R + i * D + d), c, a);
    }
    if (s_self) {
      const float p = expf(s_self[i] - m);
      l += p;
      a = fmaf(p, to_f(v_self[d]), a);
    }
    if (o) {
      o[i * D + d] = from_f<T>(a / fmaxf(l, 1e-30f));
    } else {
      dst[2 * R + i * D + d] = a;
      if (d == 0) {
        dst[i] = m;
        dst[R + i] = l;
      }
    }
  }
}

// One block: query rows q + i * D (i < nrows) against the keys [k0, k1) of
// its split, key t's K and V rows at kb + off(t) and vb + off(t); the own
// token's K/V rows k_self, v_self (paged decode) or nullptr. Writes
// o + i * D, through the workspace `ws` (this row group's nsplit partials)
// and its `ticket` when nsplit > 1. scale = 1 / sqrt(D).
template <typename T, int D, int R, typename Off>
__device__ __forceinline__ void attend(const T* __restrict__ q, const T* __restrict__ kb,
                                       const T* __restrict__ vb, Off off, int k0, int k1,
                                       const T* __restrict__ k_self, const T* __restrict__ v_self,
                                       T* __restrict__ o, int nrows, int nsplit, int split,
                                       float* __restrict__ ws, int* __restrict__ ticket,
                                       float scale, char* smem) {
  using G = Geo<T, D>;
  constexpr int VEC = G::VEC, CH = G::CH, LANES = G::LANES, GROUPS = G::GROUPS;
  constexpr int NKP = G::NKP, KPT = G::KPT;
  constexpr int KB = KPT < (R < 8 ? 8 / R : 1) ? KPT : (R < 8 ? 8 / R : 1);  // keys a batch
  constexpr int SS = state_floats(R, D);
  T* k_s = reinterpret_cast<T*>(smem);                 // [STAGES][KT][D]
  T* v_s = k_s + STAGES * KT * D;                      // [STAGES][KT][D]
  float* s_self = reinterpret_cast<float*>(smem + main_bytes<T, D, R>());   // [R]
  int* flag = reinterpret_cast<int*>(s_self + 8);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kp = warp * GROUPS + lane / LANES;         // this lane's key processor
  const int c = lane % LANES;                          // and its vector of a row
  const bool act = c < CH;

  const int nk = k1 > k0 ? k1 - k0 : 0;
  const int ntiles = (nk + KT - 1) / KT;
  auto load_tile = [&](int j) {
    T* ks = k_s + (j % STAGES) * KT * D;
    T* vs = v_s + (j % STAGES) * KT * D;
#pragma unroll
    for (int x = 0; x < (KT * CH + THREADS - 1) / THREADS; ++x) {
      const int e = tid + x * THREADS, r = e / CH, cc = e % CH, t = k0 + j * KT + r;
      if (KT * CH % THREADS && e >= KT * CH) break;
      const bool ok = t < k1;
      const long rb = ok ? off(t) : 0;                 // any valid address: nothing is read
      cp_async16(ks + r * D + cc * VEC, kb + rb + cc * VEC, ok);
      cp_async16(vs + r * D + cc * VEC, vb + rb + cc * VEC, ok);
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < ntiles) load_tile(j);
    cp_async_commit();
  }

  float qv[R][VEC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (act && i < nrows) {
      load16(qv[i], q + i * D + c * VEC);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) qv[i][v] = 0.f;
    }
  }
  float m[R], l[R], acc[R][VEC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;
  }

  for (int j = 0; j < ntiles; ++j) {
    if (j + STAGES - 1 < ntiles) load_tile(j + STAGES - 1);
    cp_async_commit();                   // possibly empty: keeps the count uniform
    cp_async_wait<STAGES - 1>();         // tile j has landed
    __syncthreads();
    const T* ks = k_s + (j % STAGES) * KT * D;
    const T* vs = v_s + (j % STAGES) * KT * D;
    const int t0 = k0 + j * KT;
#pragma unroll
    for (int b0 = 0; b0 < KPT; b0 += KB) {
      // warp-uniform: no key of this batch lies in the split
      if (t0 + warp * GROUPS + NKP * b0 >= k1) break;
      float s[R][KB];
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        float kv[VEC];
        if (act) {
          load16(kv, ks + (kp + NKP * (b0 + u)) * D + c * VEC);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) kv[v] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float dot = 0.f;
#pragma unroll
          for (int v = 0; v < VEC; ++v) dot = fmaf(qv[i][v], kv[v], dot);
          s[i][u] = dot;
        }
      }
#pragma unroll
      for (int sh = LANES / 2; sh; sh >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int u = 0; u < KB; ++u) s[i][u] += __shfl_xor_sync(FULL, s[i][u], sh);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float mx = m[i];
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          const bool ok = t0 + kp + NKP * (b0 + u) < k1;
          s[i][u] = ok ? s[i][u] * scale : NEG_INF;
          mx = fmaxf(mx, s[i][u]);
        }
        const float alpha = expf(m[i] - mx);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          const bool ok = t0 + kp + NKP * (b0 + u) < k1;
          s[i][u] = ok ? expf(s[i][u] - mx) : 0.f;
          psum += s[i][u];
        }
        l[i] = fmaf(l[i], alpha, psum);
        m[i] = mx;
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[i][v] *= alpha;
      }
      if (act) {
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          float vv[VEC];
          load16(vv, vs + (kp + NKP * (b0 + u)) * D + c * VEC);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[i][v] = fmaf(s[i][u], vv[v], acc[i][v]);
        }
      }
    }
    __syncthreads();                     // stage j % STAGES is free for tile j + STAGES
  }
  cp_async_wait<0>();                    // only empty groups remain; the ring is free

  // the key processors' states, in processor order, over the ring
  float* st = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (c == 0) {
      st[kp * SS + i] = m[i];
      st[kp * SS + R + i] = l[i];
    }
    if (act) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) st[kp * SS + 2 * R + i * D + c * VEC + v] = acc[i][v];
    }
  }
  // the own token's score of each row, by the first key processor (its
  // lanes hold every vector of q)
  auto self_scores = [&]() {
    if (warp == 0) {
      float kv[VEC];
      if (act) {
        load16(kv, k_self + c * VEC);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) kv[v] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) dot = fmaf(qv[i][v], kv[v], dot);
#pragma unroll
        for (int sh = LANES / 2; sh; sh >>= 1) dot += __shfl_xor_sync(FULL, dot, sh);
        if (lane == 0) s_self[i] = dot * scale;
      }
    }
  };
  if (nsplit == 1) {
    if (k_self) self_scores();
    __syncthreads();
    merge_states<T, D, R, false>(st, NKP, nrows, k_self ? s_self : nullptr, v_self, o, nullptr);
    return;
  }
  __syncthreads();
  merge_states<T, D, R, false>(st, NKP, nrows, nullptr, v_self, nullptr, ws + split * SS);
  __threadfence();                       // the partial is visible before the ticket
  __syncthreads();
  if (tid == 0) {
    const int last = atomicAdd(ticket, 1) == nsplit - 1;
    if (last) *ticket = 0;               // ready for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (k_self) self_scores();
  __syncthreads();
  merge_states<T, D, R, true>(ws, nsplit, nrows, k_self ? s_self : nullptr, v_self, o, nullptr);
}

}  // namespace dec
}  // namespace rt

// Dispatch the query rows a block holds (1, 2, 4 or 8) to the compile-time R.
#define RT_DISPATCH_R(RR, ...)                               \
  switch (RR) {                                              \
    case 1: { constexpr int R = 1; __VA_ARGS__; }            \
    case 2: { constexpr int R = 2; __VA_ARGS__; }            \
    case 4: { constexpr int R = 4; __VA_ARGS__; }            \
    case 8: { constexpr int R = 8; __VA_ARGS__; }            \
    default: return (int)cudaErrorInvalidValue;              \
  }

// Query rows a decode block holds for g rows of a kv head: the smallest of
// 1, 2, 4, 8 that holds min(g, 8) (kernels/decode_attention.py mirrors it).
static inline int rt_rows_per_block(int g) {
  int r = 1;
  while (r < g && r < 8) r *= 2;
  return r;
}
