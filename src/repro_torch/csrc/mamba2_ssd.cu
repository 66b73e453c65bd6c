// The Mamba2 SSD recurrence over a whole segment.
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
// surrounds the kernel. Any T >= 1, with no padding copy.
//
// Bound on the H100: bytes. x, B, C (bf16) and dt read once, y written once
// (fp32) and the two states: ~67 MB at zamba2-2.7b's prefill of 4 x 451
// tokens, 0.020 ms at 3.35 TB/s. The work is ~4 N P operations a token and
// head, ~40 a byte at N = 64, far under the bf16 tensor cores' balance
// point.
//
// What held the first version (one token at a time on the CUDA cores, the
// fp32 route below) at 14x its bound: 451 dependent token steps a block.
// Its estimated shared-load issue (35 32-bit loads a warp per token, ~840
// clocks a token per SM, ~215 us) was not the limit: fewer loads, as
// float4, made it slower (below).
//
// Design. The grid is the TPU kernel's: one block per (head, sequence)
// walks the segment in order; the state lives in mma accumulators for the
// whole segment and is written once at the end.
//   - bf16 inputs (the model's path): the chunked matrix form of the TPU
//     kernel at LC = 64 tokens a chunk (8 dependent steps at 451 tokens;
//     32 tokens timed the same, 128 slower: chip_smoke.py times all three
//     through mamba2_ssd_launch_chunk, built at N = P = 64), eight warps;
//     32 tokens at N = P = 128, where the tiles of 64 do not fit a block's
//     shared memory. The chunk's x, B, C (16-byte cp.async, so the three
//     must start on 16-byte boundaries: the launcher refuses others) and dt
//     (4-byte cp.async) arrive two chunks ahead of the one computed; rows
//     past T are
//     zero-filled, so dt = 0 (no decay, no update) and x = B = C = 0 there,
//     and the ragged last chunk needs no other mask. Two barriers a chunk:
//       prep    S published to shared memory; every warp scans the chunk's
//               decays itself (cum, LC / 32 rows a lane) and splits its
//               share of x_j e^(m - cum_j) dt_j; warp 0 stores the per-row
//               factors e^(cum_i - m/2), e^(m/2 - cum_j) dt_j and e^cum_i;
//       y       rows 16i..16i+15 of the chunk (warp w: tile w % 4, half the
//               columns): e^cum_i (C . S)  +  masked scores . x, where the
//               scores are C . B^T (exact, one product: both raw bf16) times
//               the per-(i, j) factor e^(cum_i - m/2) e^(m/2 - cum_j) dt_j,
//               applied in fp32 on the fragments, the masked half selected
//               away; then S <- e^m S + B^T (x e^(m - cum) dt) into the
//               accumulators, and the wait for chunk c + 1.
//     Every product is mma.sync m16n8k16 with fp32 sums; an fp32 operand
//     is split into 3 bf16 terms (mma_attention.cuh split_pack) against an
//     exact bf16 one (x, B, C), so each takes 3 products. A CPU model of
//     this arithmetic (tests/test_torch_recurrence_split.py) holds it to
//     the per-token fp32 oracle within 1e-4; on 2-term operands the model
//     reads 2.8-32x farther from the oracle (its control case, chunk 64).
//   - fp32 inputs (off the model's paths), one token at a time on the CUDA
//     cores: thread (p, part) holds column p of S, rows n = 4 i + part, and
//     reads the staged B and C as neighbouring 32-bit words. Contiguous rows
//     read as float4 timed slower on an H100, with the rows skewed against
//     bank conflicts too.
//
// Precondition of the chunked form: la >= -1, which the clamp guarantees,
// so every exponent is at most 1 * LC / 2 and fp32-safe.
#include "common.cuh"
#include "mma_attention.cuh"

using namespace rt;
using rt::mma::bf16;

namespace {

constexpr float DECAY_CLAMP = 1.f;

// ------------------------------------------------------- the chunked form
constexpr int WARPS = 8;
constexpr int CHUNK = 64;                  // tokens a chunk of the path's launches

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int N, int P, int LC>
struct SsdSmem {
  static constexpr int PN = N + 8, PP = P + 8;   // bf16 row pitches
  static constexpr int K = 3;                    // bf16 terms of a split fp32 operand
  struct Stage {
    bf16 x[LC][PP], bm[LC][PN], cm[LC][PN];
    float dt[LC];
  } stage[2];
  bf16 xw[K][LC][PP];                      // x_j e^(m - cum_j) dt_j, split
  bf16 s[K][N][PP];                        // the state before this chunk, split
  float fi[LC];                            // e^(cum_i - m/2)
  float gj[LC];                            // e^(m/2 - cum_j) dt_j
  float ec[LC];                            // e^cum_i
};

// The chunk of a launch at N, P: CHUNK, or half of it where CHUNK tokens'
// tiles exceed a block's shared memory (N = P = 128)
template <int N, int P>
constexpr int CHUNK_AT = sizeof(SsdSmem<N, P, CHUNK>) <= MAX_SMEM ? CHUNK : CHUNK / 2;

template <int N, int P, int LC>
__global__ void __launch_bounds__(WARPS * 32, (N <= 64 && P <= 64 && LC <= 64) ? 2 : 1)
ssd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, const float* __restrict__ dt,
               const float* __restrict__ a_log, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ s_out, int T_, int H) {
  using Sm = SsdSmem<N, P, LC>;
  constexpr int THREADS = WARPS * 32;
  constexpr int YM = LC / 16, YG = WARPS / YM, YNP = cdiv(P / 16, YG);   // y tiles
  constexpr int SMT = N / 16, SG = WARPS / SMT, SNP = cdiv(P / 16, SG);  // state tiles
  static_assert(WARPS % YM == 0 && WARPS % SMT == 0, "whole tile rows a warp");
  static_assert(LC % 32 == 0, "the scan takes LC / 32 rows a lane");
  constexpr int K = Sm::K;
  constexpr int SPLANE = N * Sm::PP, XPLANE = LC * Sm::PP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int ym = warp % YM, yp0 = (warp / YM) * YNP;     // y row tile, first column pair
  const int sr0 = (warp % SMT) * 16, sp0 = (warp / SMT) * SNP;   // state rows, pairs
  const long st_off = ((long)b * H + h) * N * P;         // S[n][p] at st_off + n * P + p
  const float a = -expf(a_log[h]);
  const int nchunks = (T_ + LC - 1) / LC;

  // this thread's 16-byte pieces of a chunk: x rows, then B and C rows; its
  // dt row. The sources are worked out at each load, not held in registers
  // across the chunk loop: held, they made ssd_mma_kernel<64,64,64> spill
  constexpr int CX = P / 8, CN = N / 8;    // 16-byte pieces of a row
  constexpr int JX = (LC * CX + THREADS - 1) / THREADS, JN = (2 * LC * CN + THREADS - 1) / THREADS;
  auto load_chunk = [&](int c, int st) {
    auto& in = sm.stage[st];
    const long row0 = (long)b * T_ + c * LC;     // the chunk's first (sequence, token) row
#pragma unroll
    for (int j = 0; j < JX; ++j) {
      const int e = tid + j * THREADS, i = e / CX;
      if (LC * CX % THREADS == 0 || e < LC * CX) {
        const bool ok = c * LC + i < T_;
        cp_async16(&in.x[i][e % CX * 8], ok ? x + ((row0 + i) * H + h) * P + e % CX * 8 : x, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int e = tid + j * THREADS, which = e / (LC * CN), i = e % (LC * CN) / CN;
      if (2 * LC * CN % THREADS == 0 || e < 2 * LC * CN) {
        const bool ok = c * LC + i < T_;
        bf16* dst = which ? &in.cm[i][e % CN * 8] : &in.bm[i][e % CN * 8];
        cp_async16(dst, ok ? (which ? cm : bm) + (row0 + i) * N + e % CN * 8 : bm, ok);
      }
    }
    if (tid < LC) {
      const bool ok = c * LC + tid < T_;
      cp_async4(&in.dt[tid], ok ? dt + (row0 + tid) * H + h : dt, ok);
    }
  };

  // this warp's state rows sr0 + g (+ 8), column pairs sp0 .. sp0 + SNP - 1
  float sacc[2 * SNP][4];
#pragma unroll
  for (int nt = 0; nt < 2 * SNP; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = sr0 + g + (e >> 1) * 8, col = sp0 * 16 + nt * 8 + 2 * tq + (e & 1);
      sacc[nt][e] = s0 && col < P ? s0[st_off + (long)row * P + col] : 0.f;
    }
  auto publish = [&]() {
#pragma unroll
    for (int nt = 0; nt < 2 * SNP; ++nt) {
      const int col = sp0 * 16 + nt * 8 + 2 * tq;
      if (col < P) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          mma::split_store<K>(sacc[nt][2 * hf], sacc[nt][2 * hf + 1],
                              &sm.s[0][sr0 + g + 8 * hf][col], SPLANE);
      }
    }
  };
  load_chunk(0, 0);
  cp_async_commit();
  if (nchunks > 1) load_chunk(1, 1);
  cp_async_commit();                       // possibly empty: keeps the count uniform
  cp_async_wait<1>();                      // chunk 0 has landed
  __syncthreads();

  // Per chunk, two barriers: every warp scans the chunk's decays itself, so
  // the prep needs no barrier of its own.
  for (int c = 0; c < nchunks; ++c) {
    const int st = c & 1;
    auto& in = sm.stage[st];
    publish();                             // the state before chunk c

    // prep: the chunk's cumulative decay, LC / 32 consecutive rows a lane,
    // scanned by every warp; row j's values sit on lane j / E, slot j % E
    constexpr int E = LC / 32;
    float cum[E], wj[E], run = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      run += fminf(fmaxf(a * in.dt[lane * E + e], -DECAY_CLAMP), 0.f);
      cum[e] = run;
    }
    float tot = run;                       // inclusive scan of the lanes' sums
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(FULL, tot, o);
      if (lane >= o) tot += up;
    }
    const float base = tot - run, m = __shfl_sync(FULL, tot, 31), half = 0.5f * m;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = lane * E + e;
      const float cj = base + cum[e], d = in.dt[j];
      wj[e] = expf(m - cj) * d;
      if (warp == 0) {
        sm.fi[j] = expf(cj - half);
        sm.gj[j] = expf(half - cj) * d;
        sm.ec[j] = expf(cj);
      }
    }
    for (int e = tid; e < LC * P / 2; e += THREADS) {
      const int j = e / (P / 2), p = 2 * (e % (P / 2));
      float w = 0.f;
#pragma unroll
      for (int q = 0; q < E; ++q) {
        const float wq = __shfl_sync(FULL, wj[q], j / E);
        if (j % E == q) w = wq;
      }
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(&in.x[j][p]);
      mma::split_store<K>(__low2float(xv) * w, __high2float(xv) * w, &sm.xw[0][j][p], XPLANE);
    }
    __syncthreads();

    // y: rows i = 16 ym + g (+ 8), column pairs yp0 .. yp0 + YNP - 1
    if (c * LC + ym * 16 < T_) {
      uint32_t ca[N / 16][4];                // this tile's C rows: A fragments, exact
#pragma unroll
      for (int kn = 0; kn < N / 16; ++kn)
        mma::ldmatrix_x4(ca[kn], &in.cm[ym * 16 + (lane & 15)][kn * 16 + (lane >> 4) * 8]);
      float yacc[2 * YNP][4] = {};
      // C . S, S split
#pragma unroll
      for (int kn = 0; kn < N / 16; ++kn)
#pragma unroll
        for (int np = 0; np < YNP; ++np) {
          const int pc = (yp0 + np) * 16;
          if (pc < P) {
            uint32_t bs[K][4];
#pragma unroll
            for (int xx = 0; xx < K; ++xx)
              mma::ldmatrix_x4_trans(bs[xx], &sm.s[xx][kn * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                                 [pc + (lane >> 4) * 8]);
            const uint32_t (&one)[1][4] = reinterpret_cast<const uint32_t (&)[1][4]>(ca[kn]);
            mma::mma_split<1, K>(yacc[2 * np], one, bs, 0);
            mma::mma_split<1, K>(yacc[2 * np + 1], one, bs, 1);
          }
        }
      const int i_lo = ym * 16 + g, i_hi = i_lo + 8;
      {
        const float e_lo = sm.ec[i_lo], e_hi = sm.ec[i_hi];
#pragma unroll
        for (int nt = 0; nt < 2 * YNP; ++nt) {
          yacc[nt][0] *= e_lo;
          yacc[nt][1] *= e_lo;
          yacc[nt][2] *= e_hi;
          yacc[nt][3] *= e_hi;
        }
      }
      // the intra-chunk part, key blocks kb <= ym
      const float f_lo = sm.fi[i_lo], f_hi = sm.fi[i_hi];
      for (int kb = 0; kb <= ym; ++kb) {
        float gacc[2][4] = {};
#pragma unroll
        for (int kn = 0; kn < N / 16; ++kn) {
          uint32_t bb[4];
          mma::ldmatrix_x4(bb, &in.bm[kb * 16 + (lane & 7) + ((lane >> 4) << 3)]
                                     [kn * 16 + ((lane >> 3) & 1) * 8]);
          mma::mma_bf16(gacc[0], ca[kn], bb[0], bb[1]);
          mma::mma_bf16(gacc[1], ca[kn], bb[2], bb[3]);
        }
        float sv[2][4];                      // scaled, masked scores
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = kb * 16 + nt * 8 + 2 * tq;
          const float g0 = sm.gj[j], g1 = sm.gj[j + 1];
          sv[nt][0] = j <= i_lo ? gacc[nt][0] * f_lo * g0 : 0.f;
          sv[nt][1] = j + 1 <= i_lo ? gacc[nt][1] * f_lo * g1 : 0.f;
          sv[nt][2] = j <= i_hi ? gacc[nt][2] * f_hi * g0 : 0.f;
          sv[nt][3] = j + 1 <= i_hi ? gacc[nt][3] * f_hi * g1 : 0.f;
        }
        uint32_t sa[K][4], w0[K], w1[K], w2[K], w3[K];
        mma::split_pack<K>(sv[0][0], sv[0][1], w0);
        mma::split_pack<K>(sv[0][2], sv[0][3], w1);
        mma::split_pack<K>(sv[1][0], sv[1][1], w2);
        mma::split_pack<K>(sv[1][2], sv[1][3], w3);
#pragma unroll
        for (int xx = 0; xx < K; ++xx) {
          sa[xx][0] = w0[xx];
          sa[xx][1] = w1[xx];
          sa[xx][2] = w2[xx];
          sa[xx][3] = w3[xx];
        }
#pragma unroll
        for (int np = 0; np < YNP; ++np) {
          const int pc = (yp0 + np) * 16;
          if (pc < P) {
            uint32_t bx[1][4];
            mma::ldmatrix_x4_trans(bx[0], &in.x[kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                               [pc + (lane >> 4) * 8]);
            mma::mma_split<K, 1>(yacc[2 * np], sa, bx, 0);
            mma::mma_split<K, 1>(yacc[2 * np + 1], sa, bx, 1);
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = c * LC + i_lo + 8 * hf;
        if (t < T_) {
          float* yr = y + (((long)b * T_ + t) * H + h) * P;
#pragma unroll
          for (int nt = 0; nt < 2 * YNP; ++nt) {
            const int col = yp0 * 16 + nt * 8 + 2 * tq;
            if (col < P)
              *reinterpret_cast<float2*>(yr + col) =
                  make_float2(yacc[nt][2 * hf], yacc[nt][2 * hf + 1]);
          }
        }
      }
    }

    // S <- e^m S + B^T (x e^(m - cum) dt): the warp's rows and column pairs
    {
      const float em = expf(m);
#pragma unroll
      for (int nt = 0; nt < 2 * SNP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] *= em;
#pragma unroll
      for (int kb = 0; kb < LC / 16; ++kb) {
        uint32_t ba[1][4];                   // B^T: rows n, k = j (ldmatrix.trans of B)
        mma::ldmatrix_x4_trans(ba[0], &in.bm[kb * 16 + (lane & 7) + ((lane >> 4) << 3)]
                                            [sr0 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int np = 0; np < SNP; ++np) {
          const int pc = (sp0 + np) * 16;
          if (pc < P) {
            uint32_t bx[K][4];
#pragma unroll
            for (int xx = 0; xx < K; ++xx)
              mma::ldmatrix_x4_trans(bx[xx], &sm.xw[xx][kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                                  [pc + (lane >> 4) * 8]);
            mma::mma_split<1, K>(sacc[2 * np], ba, bx, 0);
            mma::mma_split<1, K>(sacc[2 * np + 1], ba, bx, 1);
          }
        }
      }
    }
    cp_async_wait<0>();                    // chunk c + 1 has landed
    __syncthreads();                       // ... for every thread; chunk c is consumed
    if (c + 2 < nchunks) load_chunk(c + 2, st);
    cp_async_commit();
  }
#pragma unroll
  for (int nt = 0; nt < 2 * SNP; ++nt) {
    const int col = sp0 * 16 + nt * 8 + 2 * tq;
    if (col < P) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(s_out + st_off + (long)(sr0 + g + 8 * hf) * P + col) =
            make_float2(sacc[nt][2 * hf], sacc[nt][2 * hf + 1]);
    }
  }
}

template <int N, int P, int LC>
int launch_mma(const void* x, const void* bm, const void* cm, const float* dt,
               const float* a_log, const float* s0, float* y, float* s_out, int B, int T_,
               int H, cudaStream_t stream) {
  static_assert(sizeof(SsdSmem<N, P, LC>) <= MAX_SMEM, "a chunk's tiles fit a block");
  if (!aligned16(x) || !aligned16(bm) || !aligned16(cm)) return (int)cudaErrorMisalignedAddress;
  return rt_launch(ssd_mma_kernel<N, P, LC>, dim3(H, B), dim3(WARPS * 32),
                   sizeof(SsdSmem<N, P, LC>), stream, (const bf16*)x, (const bf16*)bm,
                   (const bf16*)cm, dt, a_log, s0, y, s_out, T_, H);
}

// ------------------------------------------------- the per-token fp32 form
constexpr int SPLIT = 4;                   // threads per state column

template <int N, int P>
__host__ __device__ constexpr int tokens_per_tile() {
  return (2 * N + P + 2) * 32 * 4 <= 40960 ? 32 : 16;   // at most 40 KB of staged fp32
}

template <int N, int P>
__global__ void __launch_bounds__(P * SPLIT)
ssd_token_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                 const float* __restrict__ cm, const float* __restrict__ dt,
                 const float* __restrict__ a_log, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_out, int T_, int H) {
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
      b_s[t][n] = bm[off];
      c_s[t][n] = cm[off];
    }
    for (int e = threadIdx.x; e < nt * P; e += blockDim.x) {
      const int t = e / P, q = e % P;
      x_s[t][q] = x[(((long)b * T_ + t0 + t) * H + h) * P + q];
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

template <int N, int P>
int launch_token(const void* x, const void* bm, const void* cm, const float* dt,
                 const float* a_log, const float* s0, float* y, float* s_out, int B, int T_,
                 int H, cudaStream_t stream) {
  return rt_launch(ssd_token_kernel<N, P>, dim3(H, B), dim3(P * SPLIT), 0, stream,
                   (const float*)x, (const float*)bm, (const float*)cm, dt, a_log, s0, y,
                   s_out, T_, H);
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
// fp32 are written. Contiguous. bf16 takes the chunked tensor-core form (LC
// = CHUNK_AT; x, B, C 16-byte aligned, else cudaErrorMisalignedAddress),
// fp32 the per-token one. Returns a cudaError_t code.
extern "C" int mamba2_ssd_launch(const void* x, const void* bm, const void* cm, const void* dt,
                                 const void* a_log, const void* state0, void* y,
                                 void* state_out, int B, int T, int H, int N, int P,
                                 int is_bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *d = (const float*)dt, *al = (const float*)a_log, *s0 = (const float*)state0;
  float *yy = (float*)y, *so = (float*)state_out;
  SSD_DISPATCH_N(N, SSD_DISPATCH_P(P, return is_bf16
      ? launch_mma<SN, SP, CHUNK_AT<SN, SP>>(x, bm, cm, d, al, s0, yy, so, B, T, H, st)
      : launch_token<SN, SP>(x, bm, cm, d, al, s0, yy, so, B, T, H, st)));
}

// The bf16 chunked form at a chunk of 64 or 128 tokens, at N = P = 64 only
// (zamba2's): the same arguments as mamba2_ssd_launch, for timing the two.
extern "C" int mamba2_ssd_launch_chunk(const void* x, const void* bm, const void* cm,
                                       const void* dt, const void* a_log, const void* state0,
                                       void* y, void* state_out, int B, int T, int H, int N,
                                       int P, int chunk, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || N != 64 || P != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *d = (const float*)dt, *al = (const float*)a_log, *s0 = (const float*)state0;
  float *yy = (float*)y, *so = (float*)state_out;
  if (chunk == 32) return launch_mma<64, 64, 32>(x, bm, cm, d, al, s0, yy, so, B, T, H, st);
  if (chunk == 64) return launch_mma<64, 64, 64>(x, bm, cm, d, al, s0, yy, so, B, T, H, st);
  if (chunk == 128) return launch_mma<64, 64, 128>(x, bm, cm, d, al, s0, yy, so, B, T, H, st);
  return (int)cudaErrorInvalidValue;
}

// The launch configuration at state size N and head channels P, bf16 (the
// chunked form at CHUNK_AT<N, P>) or fp32 (the per-token form, static shared
// memory only) (common.cuh rt_query).
extern "C" int mamba2_ssd_smem(int N, int P, int is_bf16, long long* out) {
  SSD_DISPATCH_N(N, SSD_DISPATCH_P(P, return is_bf16
      ? rt_query(ssd_mma_kernel<SN, SP, CHUNK_AT<SN, SP>>, sizeof(SsdSmem<SN, SP, CHUNK_AT<SN, SP>>),
                 WARPS * 32, out)
      : rt_query(ssd_token_kernel<SN, SP>, 0, SP * SPLIT, out)));
}

// The same for mamba2_ssd_launch_chunk's instantiations (N = P = 64).
extern "C" int mamba2_ssd_chunk_smem(int chunk, long long* out) {
  if (chunk == 32) return rt_query(ssd_mma_kernel<64, 64, 32>, sizeof(SsdSmem<64, 64, 32>),
                                   WARPS * 32, out);
  if (chunk == 64) return rt_query(ssd_mma_kernel<64, 64, 64>, sizeof(SsdSmem<64, 64, 64>),
                                   WARPS * 32, out);
  if (chunk == 128) return rt_query(ssd_mma_kernel<64, 64, 128>, sizeof(SsdSmem<64, 64, 128>),
                                    WARPS * 32, out);
  return (int)cudaErrorInvalidValue;
}
