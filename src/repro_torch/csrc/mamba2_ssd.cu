// The Mamba2 SSD recurrence over a whole segment, per token.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py (mamba2_ssd_htp,
// body _ssd_kernel). Per (sequence b, head h), with an N x P fp32 state S:
//     la_t = clip(-exp(a_log[h]) * dt_t, -1, 0)
//     S[n][p] = exp(la_t) * S[n][p] + dt_t * B_t[n] * x_t[p]
//     y_t[p] = sum_n C_t[n] * S[n][p]
// y_t reads the state AFTER token t's update (inclusive). B and C are shared
// by all heads. The clamp is here, as in the TPU kernel; the model adds
// D * x after the kernel. Returns y (fp32) and the final state (fp32);
// state0 = nullptr means zeros.
//
// Layout: the model's own, x/y (B, T, H, P), B/C (B, T, N), dt (B, T, H),
// a_log (H,), states (B, H, N, P), all contiguous, so no transpose
// surrounds the kernel. Any T >= 1: there is no chunk to pad.
//
// Bound on the H100: bytes. Each token costs ~4 N P operations per head
// against ~(2 + 4) P bytes of x (bf16) and y (fp32) per head (B and C are
// shared across heads), about 40 operations per byte at N = 64: on the bf16
// tensor cores that is far under the balance point, so the floor is x, B,
// C and dt read once, y written once and the two states over 3.35 TB/s.
// This first version is latency-bound instead: the T tokens are a chain of
// dependent steps inside one block.
//
// Design, as for the WKV kernel: the TPU kernel carried S in VMEM across a
// sequential grid axis in the chunked matrix form; here one block owns
// (h, b) for the whole segment, the state stays in registers (thread
// (p, part) holds column p of S, rows n = i * SPLIT + part), and tiles of
// TT tokens' B, C, x, dt and decay are staged in shared memory, from where
// every thread reads the broadcast vectors. The decay exp(la) <= 1, so
// nothing can overflow.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int SPLIT = 4;                   // threads per state column
constexpr float DECAY_CLAMP = 1.f;

template <int N, int P>
__host__ __device__ constexpr int tokens_per_tile() {
  return (2 * N + P + 2) * 32 * 4 <= 40960 ? 32 : 16;   // at most 40 KB of staged fp32
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(P * SPLIT)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
           const float* __restrict__ dt, const float* __restrict__ a_log,
           const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ s_out,
           int T_, int H) {
  constexpr int R = N / SPLIT;             // state rows per thread
  constexpr int TT = tokens_per_tile<N, P>();
  __shared__ float b_s[TT][N], c_s[TT][N], x_s[TT][P], dt_s[TT], dec_s[TT];

  const int h = blockIdx.x, b = blockIdx.y;
  const int p = threadIdx.x / SPLIT, part = threadIdx.x % SPLIT;
  const long st_off = ((long)b * H + h) * N * P;   // S[n][p] at st_off + n * P + p
  const float a = -expf(a_log[h]);

  float S[R];
#pragma unroll
  for (int i = 0; i < R; ++i) S[i] = s0 ? s0[st_off + (i * SPLIT + part) * P + p] : 0.f;

  for (int t0 = 0; t0 < T_; t0 += TT) {
    const int nt = min(TT, T_ - t0);
    __syncthreads();                       // the previous tile is consumed
    for (int e = threadIdx.x; e < nt * N; e += blockDim.x) {
      const int t = e / N, n = e % N;
      const long off = ((long)b * T_ + t0 + t) * N + n;
      b_s[t][n] = to_f(bm[off]);
      c_s[t][n] = to_f(cm[off]);
    }
    for (int e = threadIdx.x; e < nt * P; e += blockDim.x) {
      const int t = e / P, q = e % P;
      x_s[t][q] = to_f(x[(((long)b * T_ + t0 + t) * H + h) * P + q]);
    }
    for (int t = threadIdx.x; t < nt; t += blockDim.x) {
      const float d = dt[((long)b * T_ + t0 + t) * H + h];
      dt_s[t] = d;
      dec_s[t] = expf(fminf(fmaxf(a * d, -DECAY_CLAMP), 0.f));
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float xd = x_s[t][p] * dt_s[t];
      const float dec = dec_s[t];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = i * SPLIT + part;
        const float s = fmaf(S[i], dec, b_s[t][n] * xd);
        S[i] = s;
        acc = fmaf(c_s[t][n], s, acc);
      }
#pragma unroll
      for (int o = SPLIT / 2; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
      if (part == 0) y[(((long)b * T_ + t0 + t) * H + h) * P + p] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) s_out[st_off + (i * SPLIT + part) * P + p] = S[i];
}

template <typename T, int N, int P>
int launch(const void* x, const void* bm, const void* cm, const float* dt, const float* a_log,
           const float* s0, float* y, float* s_out, int B, int T_, int H,
           cudaStream_t stream) {
  return rt_launch(ssd_kernel<T, N, P>, dim3(H, B), dim3(P * SPLIT), 0, stream, (const T*)x,
                   (const T*)bm, (const T*)cm, dt, a_log, s0, y, s_out, T_, H);
}

}  // namespace

// Dispatch the state size N (16, 32, 64 or 128) to the compile-time SN.
#define SSD_DISPATCH_N(N, ...)                               \
  switch (N) {                                               \
    case 16: { constexpr int SN = 16; __VA_ARGS__; }         \
    case 32: { constexpr int SN = 32; __VA_ARGS__; }         \
    case 64: { constexpr int SN = 64; __VA_ARGS__; }         \
    case 128: { constexpr int SN = 128; __VA_ARGS__; }       \
    default: return (int)cudaErrorInvalidValue;              \
  }

// Dispatch the head channels P (16, 32, 64 or 128) to the compile-time SP.
#define SSD_DISPATCH_P(P, ...)                               \
  switch (P) {                                               \
    case 16: { constexpr int SP = 16; __VA_ARGS__; }         \
    case 32: { constexpr int SP = 32; __VA_ARGS__; }         \
    case 64: { constexpr int SP = 64; __VA_ARGS__; }         \
    case 128: { constexpr int SP = 128; __VA_ARGS__; }       \
    default: return (int)cudaErrorInvalidValue;              \
  }

// x (B, T, H, P), B/C (B, T, N), fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// dt (B, T, H) fp32 (post-softplus); a_log (H,) fp32; state0 (B, H, N, P)
// fp32 or null for zeros; y (B, T, H, P) fp32 and state_out (B, H, N, P)
// fp32 are written. Contiguous. Returns a cudaError_t code.
extern "C" int mamba2_ssd_launch(const void* x, const void* bm, const void* cm, const void* dt,
                                 const void* a_log, const void* state0, void* y,
                                 void* state_out, int B, int T, int H, int N, int P,
                                 int is_bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *d = (const float*)dt, *al = (const float*)a_log, *s0 = (const float*)state0;
  float *yy = (float*)y, *so = (float*)state_out;
  SSD_DISPATCH_N(N, SSD_DISPATCH_P(P, return is_bf16
      ? launch<__nv_bfloat16, SN, SP>(x, bm, cm, d, al, s0, yy, so, B, T, H, st)
      : launch<float, SN, SP>(x, bm, cm, d, al, s0, yy, so, B, T, H, st)));
}
