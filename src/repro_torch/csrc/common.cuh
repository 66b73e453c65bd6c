// Shared pieces of the kernels: type conversion, warp reductions, the
// 16-byte cp.async copy, the launch helper and the error string every
// library exports; and, for the attention kernels' fp32 CUDA-core route,
// the online-softmax fold of one key tile into a warp's query rows.
//
// The CUDA-core route computes in fp32: the two prefill kernels (flash,
// paged prefill) take it for fp32 inputs, since their bf16 inputs go to the
// tensor-core core of mma_attention.cuh; the decodes have a core of their
// own (decode_core.cuh). Every attention kernel uses NEG_INF = -1e30 for
// masked scores and floors the softmax denominator at 1e-30, as the TPU
// kernels in src/repro/kernels/ do.
//
// A warp owns RPW query rows; lane `l` owns the output columns
// d = l + 32 * j (j < DC = ceil(D / 32)). Every head dim D is a template
// argument: for D a multiple of 32 every column is real, otherwise (D = 80)
// the columns d >= D of the last j are masked, reading 0 and writing
// nothing, and shared-memory rows are D (or D + 1) floats long. A key tile
// holds up to 32 keys in shared memory as fp32: key t sits on lane t for
// the score and is then broadcast (shuffle) to all lanes for the P.V
// product.
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

// Whether a pointer is 16-byte aligned, as cp.async and 16-byte vector
// loads and stores need (rows are D * sizeof(T) bytes, a multiple of 16 at
// every supported head dim and type).
static inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false the destination is zeroed
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (the 4-byte form is .ca only); zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Columns per lane for a head of D columns.
__host__ __device__ constexpr int cols(int D) { return (D + 31) / 32; }

// Whether lane's column j lies inside a head of D columns: always when D is
// a multiple of 32 (the test folds away), the first D % 32 lanes of the
// last j otherwise.
template <int D>
__device__ __forceinline__ bool in_head(int lane, int j) {
  return D % 32 == 0 || lane + 32 * j < D;
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
template <int D, typename T, typename Off>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride, const T* __restrict__ src,
                                          Off off, int nk, int t_first, int t_step, int lane) {
  constexpr int DC = cols(D);
  for (int t0 = t_first; t0 < TILE; t0 += IN_FLIGHT * t_step) {
    float v[IN_FLIGHT][DC];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int t = t0 + u * t_step;
      const T* sr = src + (t < nk ? off(t) : 0);
#pragma unroll
      for (int j = 0; j < DC; ++j)
        v[u][j] = t < nk && in_head<D>(lane, j) ? to_f(sr[lane + 32 * j]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int t = t0 + u * t_step;
      if (t < TILE) {
#pragma unroll
        for (int j = 0; j < DC; ++j)
          if (in_head<D>(lane, j)) dst[t * dst_stride + lane + 32 * j] = v[u][j];
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
template <int D, int RPW, typename VRow, typename Valid>
__device__ __forceinline__ void fold_tile(RowState<cols(D), RPW>& st, const float* q,
                                          const float* ks, int nk, VRow v_row,
                                          float scale, int lane, Valid valid) {
  constexpr int DC = cols(D);
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
      for (int j = 0; j < DC; ++j)
        v[u][j] = t0 + u < nk && in_head<D>(lane, j) ? to_f(vr[lane + 32 * j]) : 0.f;
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
template <int D, int RPW, typename T, typename OutRow>
__device__ __forceinline__ void store_rows(const RowState<cols(D), RPW>& st, OutRow out_row,
                                           int lane) {
  constexpr int DC = cols(D);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    T* o = out_row(i);
    if (o == nullptr) continue;
    const float denom = fmaxf(st.l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (in_head<D>(lane, j)) o[lane + 32 * j] = from_f<T>(st.acc[i][j] / denom);
  }
}

}  // namespace rt

// Dispatch a head_dim of 32, 64, 80 or 128 to the compile-time HD.
#define RT_DISPATCH_D(D, ...)                                \
  switch (D) {                                               \
    case 32: { constexpr int HD = 32; __VA_ARGS__; }         \
    case 64: { constexpr int HD = 64; __VA_ARGS__; }         \
    case 80: { constexpr int HD = 80; __VA_ARGS__; }         \
    case 128: { constexpr int HD = 128; __VA_ARGS__; }       \
    default: return (int)cudaErrorInvalidValue;              \
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

// The launch configuration of one instantiation, for the libraries' smem
// queries (kernels/smem.py holds its estimates to these): out[0] the dynamic
// shared bytes its launcher passes, out[1] its static shared bytes and out[2]
// its registers a thread (both as ptxas gave them), out[3] its threads a
// block. Returns a cudaError_t code.
template <typename Kernel>
static int rt_query(Kernel kernel, size_t smem, int threads, long long* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = (long long)smem;
  out[1] = (long long)a.sharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = threads;
  return 0;
}

// Each kernel source is built into a library of its own, so each defines
// this once: the message for a code a launcher returned.
extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
