// The RWKV6 WKV recurrence over a whole segment, per token.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv.py (rwkv6_wkv_htn,
// body _wkv_kernel). Per (sequence b, head h), with an N x N fp32 state S
// indexed [key n][value m]:
//     y_t[m] = sum_n r_t[n] * (S[n][m] + u[n] k_t[n] v_t[m])
//     S[n][m] = exp(logw_t[n]) * S[n][m] + k_t[n] v_t[m]
// y_t reads the state BEFORE token t's update, plus the u bonus on the
// diagonal. Returns y (fp32) and the final state (fp32); state0 = nullptr
// means zeros.
//
// Layout: the model's own, r/k/v/logw/y (B, T, H, N) and u (H, N), states
// (B, H, N, N), all contiguous, so no transpose surrounds the kernel. Any
// T >= 1: the TPU kernel needed chunks that divide T (its wrapper padded);
// here there is no chunk.
//
// Bound on the H100: bytes. Each token costs ~4 N^2 operations per head
// against ~14 N bytes of r/k/v (bf16), logw and y (fp32), about 18
// operations per byte at N = 64, under the card's fp32 balance point, so
// the floor is r/k/v/logw read once, y written once and the two states over
// 3.35 TB/s. This first version is latency-bound instead: the T tokens are
// a chain of dependent steps inside one block.
//
// Design: the TPU kernel carried S in VMEM across a sequential grid axis
// and worked in the chunked matrix form. A CUDA block cannot carry state
// across blocks, so one block owns (h, b) for the whole segment and walks
// the tokens itself, and the state never leaves the SM: thread
// (m, part) holds column m of S, rows n = i * SPLIT + part, in registers.
// Tiles of TT tokens' r/k/v and decay exp(logw) are staged in shared memory
// (fp32, loads coalesced along N), from where every thread reads the
// broadcast vectors; the SPLIT threads of a column are neighbouring lanes,
// read neighbouring words (distinct banks) and sum their partial y with two
// shuffles. Every exponent is of logw <= 0, so nothing can overflow.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int SPLIT = 4;                   // threads per state column

template <int N>
__host__ __device__ constexpr int tokens_per_tile() {
  return 2048 / N;                         // 32 KB of staged fp32
}

template <typename T, int N>
__global__ void __launch_bounds__(N * SPLIT)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ logw, const float* __restrict__ u,
           const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ s_out,
           int T_, int H) {
  constexpr int R = N / SPLIT;             // state rows per thread
  constexpr int TT = tokens_per_tile<N>();
  __shared__ float r_s[TT][N], k_s[TT][N], v_s[TT][N], w_s[TT][N];

  const int h = blockIdx.x, b = blockIdx.y;
  const int m = threadIdx.x / SPLIT, part = threadIdx.x % SPLIT;
  const long st_off = ((long)b * H + h) * N * N;   // S[n][m] at st_off + n * N + m
  auto tok_off = [&](int t) { return (((long)b * T_ + t) * H + h) * N; };

  float S[R], uu[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = i * SPLIT + part;
    S[i] = s0 ? s0[st_off + n * N + m] : 0.f;
    uu[i] = u[h * N + n];
  }

  for (int t0 = 0; t0 < T_; t0 += TT) {
    const int nt = min(TT, T_ - t0);
    __syncthreads();                       // the previous tile is consumed
    for (int e = threadIdx.x; e < nt * N; e += blockDim.x) {
      const int t = e / N, n = e % N;
      const long off = tok_off(t0 + t) + n;
      r_s[t][n] = to_f(r[off]);
      k_s[t][n] = to_f(k[off]);
      v_s[t][n] = to_f(v[off]);
      w_s[t][n] = expf(logw[off]);
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float vm = v_s[t][m];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = i * SPLIT + part;
        const float kn = k_s[t][n];
        const float s = S[i];
        acc = fmaf(r_s[t][n], fmaf(uu[i] * kn, vm, s), acc);
        S[i] = fmaf(s, w_s[t][n], kn * vm);
      }
#pragma unroll
      for (int o = SPLIT / 2; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
      if (part == 0) y[tok_off(t0 + t) + m] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) s_out[st_off + (i * SPLIT + part) * N + m] = S[i];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u,
           const float* s0, float* y, float* s_out, int B, int T_, int H,
           cudaStream_t stream) {
  return rt_launch(wkv_kernel<T, N>, dim3(H, B), dim3(N * SPLIT), 0, stream, (const T*)r,
                   (const T*)k, (const T*)v, logw, u, s0, y, s_out, T_, H);
}

}  // namespace

// Dispatch the head size N (16, 32, 64 or 128) to the compile-time HN.
#define WKV_DISPATCH_N(N, ...)                               \
  switch (N) {                                               \
    case 16: { constexpr int HN = 16; __VA_ARGS__; }         \
    case 32: { constexpr int HN = 32; __VA_ARGS__; }         \
    case 64: { constexpr int HN = 64; __VA_ARGS__; }         \
    case 128: { constexpr int HN = 128; __VA_ARGS__; }       \
    default: return (int)cudaErrorInvalidValue;              \
  }

// r/k/v (B, T, H, N) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); logw
// (B, T, H, N) fp32; u (H, N) fp32; state0 (B, H, N, N) fp32 or null for
// zeros; y (B, T, H, N) fp32 and state_out (B, H, N, N) fp32 are written.
// Contiguous. Returns a cudaError_t code; 0 when the launch was taken.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v, const void* logw,
                                const void* u, const void* state0, void* y, void* state_out,
                                int B, int T, int H, int N, int is_bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *lw = (const float*)logw, *uu = (const float*)u, *s0 = (const float*)state0;
  float *yy = (float*)y, *so = (float*)state_out;
  WKV_DISPATCH_N(N, return is_bf16
      ? launch<__nv_bfloat16, HN>(r, k, v, lw, uu, s0, yy, so, B, T, H, st)
      : launch<float, HN>(r, k, v, lw, uu, s0, yy, so, B, T, H, st));
}
