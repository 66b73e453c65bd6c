// Shared pieces of the attention kernels: type conversion, warp reductions,
// the online-softmax fold of one key tile into a warp's query rows, and the
// merge of per-warp partial softmax states.
//
// Every kernel computes in fp32 and casts the output to the input type,
// with NEG_INF = -1e30 for masked scores and the softmax denominator
// floored at 1e-30, as the TPU kernels in src/repro/kernels/ do.
//
// A warp owns RPW query rows; lane `l` owns the output columns
// d = l + 32 * j (j < DC, D = 32 * DC). A key tile holds up to 32 keys in
// shared memory as fp32: key t sits on lane t for the score and is then
// broadcast (shuffle) to all lanes for the P.V product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 32;              // keys per tile: one per lane
constexpr int MAX_SMEM = 232448;      // bytes of shared memory a block may use on sm_90
constexpr int IN_FLIGHT = 8;          // key/value rows a lane loads before it uses one

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Online-softmax state of RPW query rows held by one warp.
template <int DC, int RPW>
struct RowState {
  float m[RPW], l[RPW], acc[RPW][DC];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
    }
  }
};

// Copy rows [t_first, TILE) step t_step of a key/value tile into padded
// fp32 shared memory (row t at dst + t * dst_stride). Row t < nk comes from
// src + off(t); rows past nk are zero so the score loop reads finite values.
// A lane issues the loads of IN_FLIGHT rows before it stores any, so their
// device-memory latencies overlap instead of adding up row after row.
template <int DC, typename T, typename Off>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride, const T* __restrict__ src,
                                          Off off, int nk, int t_first, int t_step, int lane) {
  for (int t0 = t_first; t0 < TILE; t0 += IN_FLIGHT * t_step) {
    float v[IN_FLIGHT][DC];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int t = t0 + u * t_step;
      const T* sr = src + (t < nk ? off(t) : 0);
#pragma unroll
      for (int j = 0; j < DC; ++j) v[u][j] = t < nk ? to_f(sr[lane + 32 * j]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int t = t0 + u * t_step;
      if (t < TILE) {
#pragma unroll
        for (int j = 0; j < DC; ++j) dst[t * dst_stride + lane + 32 * j] = v[u][j];
      }
    }
  }
}

// Fold one tile of nk <= 32 keys into the warp's rows.
//   q:        fp32 query rows in shared memory, row i at q + i * D
//   ks:       fp32 key tile in shared memory, key t at ks + t * (D + 1); the
//             +1 pad keeps the lane-per-key reads free of bank conflicts
//   v_row(t): pointer to value row t (shared fp32 or global), read by every
//             lane at its own columns
//   valid(i, t): whether row i sees key t of this tile (t < nk always holds)
template <int DC, int RPW, typename VRow, typename Valid>
__device__ __forceinline__ void fold_tile(RowState<DC, RPW>& st, const float* q,
                                          const float* ks, int nk, VRow v_row,
                                          float scale, int lane, Valid valid) {
  constexpr int D = DC * 32;
  float s[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) s[i] = 0.f;
  const float* kr = ks + lane * (D + 1);
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kd = kr[d];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = fmaf(q[i * D + d], kd, s[i]);
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const bool ok = lane < nk && valid(i, lane);
    const float si = ok ? s[i] * scale : NEG_INF;
    const float m_new = fmaxf(st.m[i], warp_max(si));
    const float p = ok ? expf(si - m_new) : 0.f;
    const float alpha = expf(st.m[i] - m_new);
    st.l[i] = st.l[i] * alpha + warp_sum(p);
    st.m[i] = m_new;
#pragma unroll
    for (int j = 0; j < DC; ++j) st.acc[i][j] *= alpha;
    s[i] = p;
  }
  // P.V: the value rows of IN_FLIGHT keys are loaded before any is used
  for (int t0 = 0; t0 < nk; t0 += IN_FLIGHT) {
    float v[IN_FLIGHT][DC];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const auto* vr = v_row(t0 + u < nk ? t0 + u : t0);
#pragma unroll
      for (int j = 0; j < DC; ++j) v[u][j] = t0 + u < nk ? to_f(vr[lane + 32 * j]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      if (t0 + u < nk) {
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float pt = __shfl_sync(FULL, s[i], t0 + u);
#pragma unroll
          for (int j = 0; j < DC; ++j) st.acc[i][j] = fmaf(pt, v[u][j], st.acc[i][j]);
        }
      }
    }
  }
}

// Write a warp's finished rows: out_row(i) is the output row of row i, or
// nullptr for a row the warp holds but does not own.
template <int DC, int RPW, typename T, typename OutRow>
__device__ __forceinline__ void store_rows(const RowState<DC, RPW>& st, OutRow out_row, int lane) {
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    T* o = out_row(i);
    if (o == nullptr) continue;
    const float denom = fmaxf(st.l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j) o[lane + 32 * j] = from_f<T>(st.acc[i][j] / denom);
  }
}

// Merge the partial states of the block's WARPS warps (each folded its own
// share of the keys) for rows [0, nrows), optionally with one extra key per
// row (score self_s[i] against the value row self_v shared by all rows: the
// decode step's own token), and write row i to out + i * D. `scratch` holds
// WARPS * RPW * (D + 2) floats and may alias the key tiles: the block
// synchronises before writing it.
template <int DC, int RPW, int WARPS, typename T>
__device__ __forceinline__ void merge_and_store(const RowState<DC, RPW>& st, float* scratch,
                                                int nrows, const float* self_s,
                                                const T* __restrict__ self_v, T* __restrict__ out,
                                                int warp, int lane) {
  constexpr int D = DC * 32;
  float* m_s = scratch;                       // [WARPS][RPW]
  float* l_s = m_s + WARPS * RPW;             // [WARPS][RPW]
  float* a_s = l_s + WARPS * RPW;             // [WARPS][RPW][D]
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (lane == 0) {
      m_s[warp * RPW + i] = st.m[i];
      l_s[warp * RPW + i] = st.l[i];
    }
#pragma unroll
    for (int j = 0; j < DC; ++j) a_s[(warp * RPW + i) * D + lane + 32 * j] = st.acc[i][j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    float m = self_s ? self_s[i] : NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, m_s[w * RPW + i]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(m_s[w * RPW + i] - m);
      l += l_s[w * RPW + i] * c;
      a += a_s[(w * RPW + i) * D + d] * c;
    }
    if (self_s) {
      const float p = expf(self_s[i] - m);
      l += p;
      a += p * to_f(self_v[d]);
    }
    out[i * D + d] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

}  // namespace rt

// Dispatch a head_dim of 32, 64 or 128 to the compile-time DC = D / 32.
#define RT_DISPATCH_D(D, ...)                                \
  switch (D) {                                               \
    case 32: { constexpr int DC = 1; __VA_ARGS__; }          \
    case 64: { constexpr int DC = 2; __VA_ARGS__; }          \
    case 128: { constexpr int DC = 4; __VA_ARGS__; }         \
    default: return (int)cudaErrorInvalidValue;              \
  }

// Dispatch the rows a warp holds (1, 2, 4 or 8) to the compile-time RPW.
#define RT_DISPATCH_RPW(R, ...)                              \
  switch (R) {                                               \
    case 1: { constexpr int RPW = 1; __VA_ARGS__; }          \
    case 2: { constexpr int RPW = 2; __VA_ARGS__; }          \
    case 4: { constexpr int RPW = 4; __VA_ARGS__; }          \
    case 8: { constexpr int RPW = 8; __VA_ARGS__; }          \
    default: return (int)cudaErrorInvalidValue;              \
  }

// Smallest supported rows-per-warp (1, 2, 4, 8) that holds min(g, 8) rows.
static inline int rt_rows_per_warp(int g) {
  int r = 1;
  while (r < g && r < 8) r *= 2;
  return r;
}

// Opt the kernel in to `smem` bytes of dynamic shared memory and launch it.
template <typename Kernel, typename... Args>
static int rt_launch(Kernel kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                     Args... args) {
  if (smem > (size_t)rt::MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, block, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Each kernel source is built into a library of its own, so each defines
// this once: the message for a code a launcher returned.
extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
