// The RWKV6 WKV recurrence over a whole segment.
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
// T >= 1, with no padding copy.
//
// Bound on the H100: bytes. r/k/v (bf16) and logw read once, y written once
// (fp32) and the two states: ~112 MB at rwkv6-7b's prefill of 4 x 451
// tokens, 0.033 ms at 3.35 TB/s. The work is ~4 N^2 operations a token and
// head, under the card's balance point in any type.
//
// What held the first version (one token at a time on the CUDA cores, the
// fp32 route below) at 7.5x its bound: 451 dependent token steps a block.
// Its estimated shared-load issue (49 32-bit loads a warp per token, ~780
// clocks a token per SM, ~190 us) was not the limit: four times fewer
// loads, as float4, made it slower (below).
//
// Design. The grid is the TPU kernel's: one block per (head, sequence)
// walks the segment in order and never publishes the state; the state
// lives in mma accumulators (warp w owns state rows 16w..16w+15) for the
// whole segment and is written once at the end.
//   - bf16 inputs (the model's path): the chunked matrix form of the TPU
//     kernel, L = 16 tokens a chunk (29 dependent steps at 451 tokens
//     instead of 451), N / 16 warps. The chunk's r/k/v/logw arrive by 16-byte
//     cp.async (so the four must start on 16-byte boundaries: the launcher
//     refuses others), two chunks ahead of the one computed; rows past T are
//     zero-filled, so k = 0 and logw = 0 there and the ragged last chunk
//     needs no other mask. With half = m / 2 per key column (m the chunk's
//     total log-decay), a_in = r e^(cum_ex - half) and b_in = k e^(half - cum):
//       scores = a_in . b_in^T (strictly lower), the u bonus r . (u k) on
//                the diagonal
//       y      = a_in . (e^half S) + scores . v
//       S     <- e^half (e^half S + b_in^T v)      [= e^m S + (k e^(m-cum))^T v]
//     so two operands serve all five products. Three barriers a chunk:
//       prep    per column pair and four rows: the cumulative log-decays
//               (fp32, in token order), a_in and b_in (two exponentials an
//               element), the bonus summed over the row's lanes in fp64;
//       parts   S scaled by e^half and published to shared memory; warp w's
//               part of the scores over key columns 16w..16w+15;
//       y       the parts summed in warp order, the mask and bonus applied,
//               then y for the warp's 16 value columns, the state update in
//               its accumulators, and the wait for chunk c + 1.
//     Every product is mma.sync m16n8k16 with fp32 sums, its fp32 operands
//     split into 3 bf16 terms (mma_attention.cuh split_pack; v is exact):
//     6 products for a_in . b_in^T and a_in . S, 3 for scores . v and
//     b_in^T v. A CPU model of this arithmetic
//     (tests/test_torch_recurrence_split.py) holds it to the per-token
//     fp32 oracle within 6e-5; with 2-term operands the model missed that
//     limit (the scores' factors span e^-64 .. e^64).
//   - fp32 inputs (off the model's paths), one token at a time on the CUDA
//     cores: thread (m, part) holds column m of S, rows n = 4 i + part, and
//     reads the staged r/k/decay vectors and u as neighbouring 32-bit words.
//     u comes from shared memory, not registers: with u in registers ptxas
//     spilled 8 bytes at N = 64 inside the token loop. Contiguous rows read
//     as float4 timed slower than these scalar loads on an H100, with the
//     rows skewed against bank conflicts too.
//
// Precondition of the chunked form: logw >= -8 (the model's clamp,
// models/rwkv6.py _decay), so every exponent is at most 8 * 16 / 2 = 64 and
// fp32-safe. The kernel does not check it.
#include "common.cuh"
#include "mma_attention.cuh"

using namespace rt;
using rt::mma::bf16;

namespace {

// ------------------------------------------------------- the chunked form
constexpr int L = 16;                      // tokens a chunk (the wrapper's CHUNK)
constexpr int SPLIT_TERMS = 3;             // bf16 terms of a split fp32 operand

template <int N>
struct WkvSmem {
  static constexpr int PB = N + 8;         // bf16 row pitch: ldmatrix rows in distinct banks
  static constexpr int W = N / 16;         // warps
  static constexpr int BP = (N / 2 + 31) / 32;   // warps summing one row's bonus
  struct Stage {
    bf16 r[L][PB], k[L][PB], v[L][PB];
    float lw[L][N];
  } stage[2];
  bf16 a_in[SPLIT_TERMS][L][PB];           // r e^(cum_ex - m/2), split
  bf16 b_in[SPLIT_TERMS][L][PB];           // k e^(m/2 - cum), split
  bf16 s[SPLIT_TERMS][N][PB];              // e^(m/2) S before this chunk, split
  float sc[W][L][L + 4];                   // warp w's scores over key columns 16w..16w+15
  float bonus[BP][L];                      // r . (u k) per row, in BP partial sums
  float eh[N];                             // e^(m/2) per key column (state row)
  float u[N];
};

template <int N>
__global__ void __launch_bounds__(2 * N)
wkv_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ s_out, int T_, int H) {
  using Sm = WkvSmem<N>;
  constexpr int W = Sm::W, THREADS = 32 * W;     // = 2N
  constexpr int K = SPLIT_TERMS;
  constexpr int SPLANE = N * Sm::PB, LPLANE = L * Sm::PB;
  constexpr int RPT = L * N / 2 / THREADS;       // prep rows a thread (of two columns): 4
  constexpr int RED = N / 2 < 32 ? N / 2 : 32;   // lanes summing a row's bonus together
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int n0 = warp * 16;                // the warp's state rows, y columns and score keys
  const long st_off = ((long)b * H + h) * N * N;
  auto tok = [&](int t) { return (((long)b * T_ + t) * H + h) * N; };
  const int nchunks = (T_ + L - 1) / L;

  // this thread's 16-byte pieces of a chunk: their sources at chunk 0 (a
  // chunk further is L * H * N elements on) and their rows
  constexpr int CB = N / 8, CF = N / 4;    // 16-byte pieces of a bf16 and an fp32 row
  constexpr int JB = (3 * L * CB + THREADS - 1) / THREADS, JF = (L * CF + THREADS - 1) / THREADS;
  const long chunk_step = (long)L * H * N;
  const bf16* bsrc[JB];
  const float* fsrc[JF];
#pragma unroll
  for (int j = 0; j < JB; ++j) {
    const int e = tid + j * THREADS, w = e / (L * CB), i = e % (L * CB) / CB, q = e % CB;
    bsrc[j] = (w == 0 ? r : w == 1 ? k : v) + tok(i) + q * 8;
  }
#pragma unroll
  for (int j = 0; j < JF; ++j) {
    const int e = tid + j * THREADS;
    fsrc[j] = logw + tok(e / CF) + e % CF * 4;
  }
  auto load_chunk = [&](int c, int st) {
    auto& S = sm.stage[st];
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      const int e = tid + j * THREADS, w = e / (L * CB), i = e % (L * CB) / CB, q = e % CB;
      if (3 * L * CB % THREADS == 0 || e < 3 * L * CB) {
        const bool ok = c * L + i < T_;
        bf16* dst = (w == 0 ? S.r[i] : w == 1 ? S.k[i] : S.v[i]) + q * 8;
        cp_async16(dst, ok ? bsrc[j] + c * chunk_step : r, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < JF; ++j) {
      const int e = tid + j * THREADS, i = e / CF, q = e % CF;
      if (L * CF % THREADS == 0 || e < L * CF) {
        const bool ok = c * L + i < T_;
        cp_async16(&S.lw[i][q * 4], ok ? fsrc[j] + c * chunk_step : logw, ok);
      }
    }
  };

  // the state rows n0 + g (+ 8), all N columns, as mma accumulators
  float sacc[N / 8][4];
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = n0 + g + (e >> 1) * 8, col = nt * 8 + 2 * tq + (e & 1);
      sacc[nt][e] = s0 ? s0[st_off + (long)row * N + col] : 0.f;
    }
  auto publish = [&]() {
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        mma::split_store<K>(sacc[nt][2 * hf], sacc[nt][2 * hf + 1],
                            &sm.s[0][n0 + g + 8 * hf][nt * 8 + 2 * tq], SPLANE);
  };
  // S rows n0 + g (+ 8) times e^(m/2) of their key column
  auto scale_rows = [&]() {
    const float e_lo = sm.eh[n0 + g], e_hi = sm.eh[n0 + g + 8];
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      sacc[nt][0] *= e_lo;
      sacc[nt][1] *= e_lo;
      sacc[nt][2] *= e_hi;
      sacc[nt][3] *= e_hi;
    }
  };
  for (int n = tid; n < N; n += THREADS) sm.u[n] = u[h * N + n];
  load_chunk(0, 0);
  cp_async_commit();
  if (nchunks > 1) load_chunk(1, 1);
  cp_async_commit();                       // possibly empty: keeps the count uniform
  cp_async_wait<1>();                      // chunk 0 has landed
  __syncthreads();

  // Per chunk, three barriers. With half = m/2 per key column n:
  //   y = (r e^cum_ex) . S + scores . v = a_in . (e^half S) + scores . v
  //   S <- e^m S + (k e^(m - cum))^T v = e^half (e^half S + b_in^T v)
  // so a_in and b_in serve the state's products too, and e^half S is what
  // is published.
  for (int c = 0; c < nchunks; ++c) {
    const int st = c & 1;
    auto& in = sm.stage[st];

    // prep: columns n, n + 1, rows i0 .. i0 + RPT - 1; the sums run in token
    // order. Every load comes before the first store.
    {
      const int n = 2 * (tid % (N / 2)), i0 = tid / (N / 2) * RPT;
      float2 lwv[RPT];
      __nv_bfloat162 rv[RPT], kv[RPT];
      float2 m = make_float2(0.f, 0.f), cum = m;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (i == i0) cum = m;
        const float2 x = *reinterpret_cast<const float2*>(&in.lw[i][n]);
        m.x += x.x;
        m.y += x.y;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        lwv[i] = *reinterpret_cast<const float2*>(&in.lw[i0 + i][n]);
        rv[i] = *reinterpret_cast<const __nv_bfloat162*>(&in.r[i0 + i][n]);
        kv[i] = *reinterpret_cast<const __nv_bfloat162*>(&in.k[i0 + i][n]);
      }
      const float2 half = make_float2(0.5f * m.x, 0.5f * m.y);
      const float2 un = *reinterpret_cast<const float2*>(&sm.u[n]);
      if (i0 == 0) *reinterpret_cast<float2*>(&sm.eh[n]) = make_float2(expf(half.x), expf(half.y));
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float2 cex = cum;
        cum.x += lwv[i].x;
        cum.y += lwv[i].y;
        const float2 rr = __bfloat1622float2(rv[i]), kk = __bfloat1622float2(kv[i]);
        const int row = i0 + i;
        mma::split_store<K>(rr.x * expf(cex.x - half.x), rr.y * expf(cex.y - half.y),
                            &sm.a_in[0][row][n], LPLANE);
        mma::split_store<K>(kk.x * expf(half.x - cum.x), kk.y * expf(half.y - cum.y),
                            &sm.b_in[0][row][n], LPLANE);
        // the u bonus r . (u k): this pair's part, summed over the row's lanes
        // in fp64 (the sum can cancel)
        double bo = (double)(rr.x * un.x) * kk.x + (double)(rr.y * un.y) * kk.y;
#pragma unroll
        for (int o = RED / 2; o; o >>= 1) bo += __shfl_xor_sync(FULL, bo, o);
        if (tid % RED == 0) sm.bonus[tid % (N / 2) / 32][row] = bo;
      }
    }
    __syncthreads();

    // publish e^half S; the warp's part of the scores: a_in . b_in^T over
    // key columns n0..n0+15, all 16 x 16 (the masked half is selected away
    // below, never multiplied)
    scale_rows();
    publish();
    {
      uint32_t a[K][4], bb[K][4];
#pragma unroll
      for (int x = 0; x < K; ++x) {
        mma::ldmatrix_x4(a[x], &sm.a_in[x][lane & 15][n0 + (lane >> 4) * 8]);
        mma::ldmatrix_x4(bb[x], &sm.b_in[x][(lane & 7) + ((lane >> 4) << 3)]
                                          [n0 + ((lane >> 3) & 1) * 8]);
      }
      float pacc[2][4] = {};
      mma::mma_split<K, K>(pacc[0], a, bb, 0);
      mma::mma_split<K, K>(pacc[1], a, bb, 1);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(&sm.sc[warp][g + 8 * hf][nt * 8 + 2 * tq]) =
              make_float2(pacc[nt][2 * hf], pacc[nt][2 * hf + 1]);
    }
    __syncthreads();

    // y (16 rows x the warp's 16 columns) = a_in . (e^half S) + scores . v,
    // the scores summed over the warps' parts in order, strictly lower, the
    // bonus on the diagonal, split into K terms
    float yacc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[K][4], bt[K][4];
#pragma unroll
      for (int x = 0; x < K; ++x) {
        mma::ldmatrix_x4(a[x], &sm.a_in[x][lane & 15][kk * 16 + (lane >> 4) * 8]);
        mma::ldmatrix_x4_trans(bt[x], &sm.s[x][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                           [n0 + (lane >> 4) * 8]);
      }
      mma::mma_split<K, K>(yacc[0], a, bt, 0);
      mma::mma_split<K, K>(yacc[1], a, bt, 1);
    }
    {
      uint32_t sa[K][4], bv[1][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {          // the A fragment's four register pairs
        const int i = g + 8 * (e & 1), j = 2 * tq + 8 * (e >> 1);
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float2 p = *reinterpret_cast<const float2*>(&sm.sc[w][i][j]);
          acc.x += p.x;
          acc.y += p.y;
        }
        float bo = 0.f;
#pragma unroll
        for (int q = 0; q < Sm::BP; ++q) bo += sm.bonus[q][i];
        const float x0 = j < i ? acc.x : j == i ? bo : 0.f;
        const float x1 = j + 1 < i ? acc.y : j + 1 == i ? bo : 0.f;
        uint32_t wv[K];
        mma::split_pack<K>(x0, x1, wv);
#pragma unroll
        for (int x = 0; x < K; ++x) sa[x][e] = wv[x];
      }
      mma::ldmatrix_x4_trans(bv[0], &in.v[(lane & 7) + ((lane >> 3) & 1) * 8][n0 + (lane >> 4) * 8]);
      mma::mma_split<K, 1>(yacc[0], sa, bv, 0);
      mma::mma_split<K, 1>(yacc[1], sa, bv, 1);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = c * L + g + 8 * hf;
      if (t < T_) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          *reinterpret_cast<float2*>(y + tok(t) + n0 + nt * 8 + 2 * tq) =
              make_float2(yacc[nt][2 * hf], yacc[nt][2 * hf + 1]);
      }
    }

    // S <- e^half (e^half S + b_in^T v): the warp's rows, one k-step of L
    {
      uint32_t ka[K][4];
#pragma unroll
      for (int x = 0; x < K; ++x)
        mma::ldmatrix_x4_trans(ka[x], &sm.b_in[x][(lane & 7) + ((lane >> 4) << 3)]
                                            [n0 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bv[1][4];
        mma::ldmatrix_x4_trans(bv[0], &in.v[(lane & 7) + ((lane >> 3) & 1) * 8]
                                          [np * 16 + (lane >> 4) * 8]);
        mma::mma_split<K, 1>(sacc[2 * np], ka, bv, 0);
        mma::mma_split<K, 1>(sacc[2 * np + 1], ka, bv, 1);
      }
      scale_rows();
    }
    cp_async_wait<0>();                    // chunk c + 1 has landed
    __syncthreads();                       // ... for every thread; chunk c is consumed
    if (c + 2 < nchunks) load_chunk(c + 2, st);
    cp_async_commit();
  }
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(s_out + st_off + (long)(n0 + g + 8 * hf) * N + nt * 8 + 2 * tq) =
          make_float2(sacc[nt][2 * hf], sacc[nt][2 * hf + 1]);
}

template <int N>
int launch_mma(const void* r, const void* k, const void* v, const float* logw, const float* u,
               const float* s0, float* y, float* s_out, int B, int T_, int H,
               cudaStream_t stream) {
  if (!aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(logw))
    return (int)cudaErrorMisalignedAddress;
  return rt_launch(wkv_mma_kernel<N>, dim3(H, B), dim3(2 * N), sizeof(WkvSmem<N>), stream,
                   (const bf16*)r, (const bf16*)k, (const bf16*)v, logw, u, s0, y, s_out, T_,
                   H);
}

// ------------------------------------------------- the per-token fp32 form
constexpr int SPLIT = 4;                   // threads per state column

template <int N>
__host__ __device__ constexpr int tokens_per_tile() {
  return 2048 / N;                         // 32 KB of staged fp32
}

template <int N>
__global__ void __launch_bounds__(N * SPLIT)
wkv_token_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_out, int T_, int H) {
  constexpr int R = N / SPLIT;             // state rows per thread
  constexpr int TT = tokens_per_tile<N>();
  __shared__ float r_s[TT][N], k_s[TT][N], v_s[TT][N], w_s[TT][N], u_s[N];

  const int h = blockIdx.x, b = blockIdx.y;
  const int m = threadIdx.x / SPLIT, part = threadIdx.x % SPLIT;
  const long st_off = ((long)b * H + h) * N * N;   // S[n][m] at st_off + n * N + m
  auto tok_off = [&](int t) { return (((long)b * T_ + t) * H + h) * N; };

  float S[R];
#pragma unroll
  for (int i = 0; i < R; ++i) S[i] = s0 ? s0[st_off + (i * SPLIT + part) * N + m] : 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) u_s[n] = u[h * N + n];

  for (int t0 = 0; t0 < T_; t0 += TT) {
    const int nt = min(TT, T_ - t0);
    __syncthreads();                       // the previous tile is consumed
    for (int e = threadIdx.x; e < nt * N; e += blockDim.x) {
      const int t = e / N, n = e % N;
      const long off = tok_off(t0 + t) + n;
      r_s[t][n] = r[off];
      k_s[t][n] = k[off];
      v_s[t][n] = v[off];
      w_s[t][n] = expf(logw[off]);
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float vm = v_s[t][m];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = i * SPLIT + part;
        const float kn = k_s[t][n], s = S[i];
        acc = fmaf(r_s[t][n], fmaf(u_s[n] * kn, vm, s), acc);
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

template <int N>
int launch_token(const void* r, const void* k, const void* v, const float* logw, const float* u,
                 const float* s0, float* y, float* s_out, int B, int T_, int H,
                 cudaStream_t stream) {
  return rt_launch(wkv_token_kernel<N>, dim3(H, B), dim3(N * SPLIT), 0, stream,
                   (const float*)r, (const float*)k, (const float*)v, logw, u, s0, y, s_out,
                   T_, H);
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
// Contiguous. bf16 takes the chunked tensor-core form (r/k/v/logw 16-byte
// aligned, else cudaErrorMisalignedAddress), fp32 the per-token one.
// Returns a cudaError_t code; 0 when the launch was taken.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v, const void* logw,
                                const void* u, const void* state0, void* y, void* state_out,
                                int B, int T, int H, int N, int is_bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *lw = (const float*)logw, *uu = (const float*)u, *s0 = (const float*)state0;
  float *yy = (float*)y, *so = (float*)state_out;
  WKV_DISPATCH_N(N, return is_bf16
      ? launch_mma<HN>(r, k, v, lw, uu, s0, yy, so, B, T, H, st)
      : launch_token<HN>(r, k, v, lw, uu, s0, yy, so, B, T, H, st));
}

// The launch configuration at head size N, bf16 (the chunked form) or fp32
// (the per-token form, static shared memory only) (common.cuh rt_query).
extern "C" int rwkv6_wkv_smem(int N, int is_bf16, long long* out) {
  WKV_DISPATCH_N(N, return is_bf16
      ? rt_query(wkv_mma_kernel<HN>, sizeof(WkvSmem<HN>), 2 * HN, out)
      : rt_query(wkv_token_kernel<HN>, 0, HN * SPLIT, out));
}
