// The tensor-core attention core shared by the two prefill kernels (flash
// and paged chunked prefill), bf16 inputs only. FlashAttention-2 in shape:
//
//   - a block owns ROWS = 64 query rows and runs 4 warps of 16 rows each;
//   - Q is staged once through shared memory (bf16) and loaded with ldmatrix
//     into mma A-fragments that stay in registers for the whole key loop;
//   - K and V arrive in KT = 64-key tiles through cp.async (16 bytes a
//     thread, zero-fill for keys past the end) into a two-stage ring: tile
//     j + 1 loads while tile j is computed. Shared-memory rows are D + 8 bf16
//     long, so the eight 16-byte rows an ldmatrix reads fall in eight
//     distinct bank groups at every head dim (no swizzle needed);
//   - S = Q K^T and O += P V run as mma.sync m16n8k16 bf16 products with
//     fp32 accumulators, K read by ldmatrix and V by ldmatrix.trans;
//   - the online softmax works on the accumulator fragments: a row's four
//     owner lanes (a quad) agree on its max with two xor shuffles, exp2f with
//     the scale folded into log2(e), and P is rounded to bf16 in registers
//     as the A operand of P V (the plain version also casts the
//     probabilities to bf16 before the value product);
//   - masked scores are NEG_INF = -1e30 and the denominator is floored at
//     1e-30, as in the TPU kernels. Only tiles that hold a key hidden from
//     some row of the warp are masked; tiles past every row are not loaded.
//
// The caller supplies only its addressing, as functors of block-local query
// row r in [0, ROWS) and key index t in [0, kend):
//   q_off(r)           element offset of query row r in q (and of its output
//                      row in o), for r < nrows;
//   kv_rows(t, kr, vr) pointers to key row t of K and of V;
//   lim(r)             row r sees exactly the keys t < lim(r); lim must be
//                      nondecreasing in r (causal prefill is), and kend =
//                      lim(nrows - 1) the keys the block reads.
// Every row that the block stores must see at least one key of the first
// tile (both callers' rows see key 0), so its running max is a real score
// before any masked score is exponentiated.
//
// The fragment helpers (ldmatrix, mma_bf16) and the error-compensated
// split of fp32 operands into bf16 terms (split_pack, mma_split) also serve
// the recurrences' chunked forms (rwkv6_wkv.cu, mamba2_ssd.cu).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace rt {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;   // query rows per block, 16 per warp
constexpr int KT = 64;             // keys per tile
constexpr int STAGES = 2;

// bf16 elements per shared-memory row
__host__ __device__ constexpr int pitch(int D) { return D + 8; }

// Blocks an SM holds, for __launch_bounds__: registers set it. At D = 128 a
// thread needs ~235 registers, so two blocks; at D <= 80 ptxas fits a thread
// in 168 without spilling, so three.
__host__ __device__ constexpr int blocks_per_sm(int D) { return D <= 80 ? 3 : 2; }

// Q staging plus the two-stage K and V rings.
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(bf16) * pitch(D) * (ROWS + 2 * STAGES * KT);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one register of two bf16, `lo` in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Error-compensated bf16 operands, for the recurrences' fp32 products on the
// tensor cores: an fp32 pair (x0, x1) becomes K bf16 pairs whose sum is the
// pair to ~2^(-8K) of its size (term k rounds what terms < k left over; each
// subtraction is exact in fp32). A product of a K-term operand with a J-term
// one takes the terms (ka, kb) with ka + kb < max(K, J): the dropped ones are
// below the representation error. A raw bf16 input is one exact term.
template <int K>
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(x0, x1);
    out[k] = *reinterpret_cast<const uint32_t*>(&p);
    x0 -= __low2float(p);
    x1 -= __high2float(p);
  }
}

// The same split stored in K planes of shared memory, plane k at dst + k * plane.
template <int K>
__device__ __forceinline__ void split_store(float x0, float x1, bf16* dst, int plane) {
  uint32_t w[K];
  split_pack<K>(x0, x1, w);
#pragma unroll
  for (int k = 0; k < K; ++k) *reinterpret_cast<uint32_t*>(dst + k * plane) = w[k];
}

// c (16 x 8) += the kept terms of a[ka] * b[kb], smallest first; b[kb] holds
// the B fragments of two n-tiles (an ldmatrix.x4), of which n-tile nt is used.
template <int KA, int KB>
__device__ __forceinline__ void mma_split(float (&c)[4], const uint32_t (&a)[KA][4],
                                          const uint32_t (&b)[KB][4], int nt) {
  constexpr int K = KA > KB ? KA : KB;
#pragma unroll
  for (int o = K - 1; o >= 0; --o) {
#pragma unroll
    for (int ka = 0; ka < KA; ++ka) {
      const int kb = o - ka;
      if (kb >= 0 && kb < KB) mma_bf16(c, a[ka], b[kb][2 * nt], b[kb][2 * nt + 1]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// One block's ROWS query rows against keys [0, kend), written to o.
// `smem` holds smem_bytes<D>(); scale_log2 = log2(e) / sqrt(D).
template <int D, typename QOff, typename KVRows, typename Lim>
__device__ __forceinline__ void attend(const bf16* __restrict__ q, bf16* __restrict__ o,
                                       QOff q_off, int nrows, KVRows kv_rows, Lim lim,
                                       int kend, float scale_log2, bf16* smem) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int P = pitch(D);
  constexpr int CPR = D / 8;     // 16-byte chunks per row
  constexpr int KS = D / 16;     // k-steps of S = Q K^T
  constexpr int NT = D / 8;      // n-tiles of O
  constexpr int ST = KT / 8;     // n-tiles of S
  bf16* q_s = smem;                          // [ROWS][P]
  bf16* k_s = q_s + ROWS * P;                // [STAGES][KT][P]
  bf16* v_s = k_s + STAGES * KT * P;         // [STAGES][KT][P]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;     // fragment row group, column pair
  const int wr = warp * 16;                  // the warp's first block row

  static_assert(ROWS * CPR % THREADS == 0 && KT * CPR % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / CPR, c = e % CPR;
    const bool ok = r < nrows;
    cp_async16(q_s + r * P + c * 8, q + (ok ? q_off(r) : 0) + c * 8, ok);
  }
  auto load_tile = [&](int t0, int stage) {
    bf16* ks = k_s + stage * KT * P;
    bf16* vs = v_s + stage * KT * P;
#pragma unroll
    for (int i = 0; i < KT * CPR / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e / CPR, c = e % CPR, t = t0 + r;
      const bool ok = t < kend;
      const bf16 *kr = q, *vr = q;           // any valid address: nothing is read
      if (ok) kv_rows(t, kr, vr);
      cp_async16(ks + r * P + c * 8, kr + c * 8, ok);
      cp_async16(vs + r * P + c * 8, vr + c * 8, ok);
    }
  };

  const int ntiles = (kend + KT - 1) / KT;
  load_tile(0, 0);
  cp_async_commit();                         // group 0: Q and tile 0

  const bool active = wr < nrows;
  const int lim_lo = lim(wr + g), lim_hi = lim(wr + g + 8);
  const int wlim_min = lim(wr), wlim_max = lim(wr + 15);
  uint32_t qf[KS][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int t0 = j * KT;
    if (j + 1 < ntiles) load_tile(t0 + KT, (j + 1) % STAGES);
    cp_async_commit();                       // possibly empty: keeps the count uniform
    cp_async_wait<1>();                      // tile j (and Q) have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], q_s + (wr + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
    }
    if (active && t0 < wlim_max) {
      const bf16* ks = k_s + (j % STAGES) * KT * P;
      const bf16* vs = v_s + (j % STAGES) * KT * P;
      float s[ST][4];
#pragma unroll
      for (int n = 0; n < ST; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      // S = Q K^T: one ldmatrix.x4 gives the B fragments of two key n-tiles
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t b[4];
          ldmatrix_x4(b, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16
                             + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        }
      }
      if (t0 + KT > wlim_min) {              // some key here is hidden from some row
#pragma unroll
        for (int n = 0; n < ST; ++n) {
          const int t = t0 + n * 8 + 2 * tq;
          if (t >= lim_lo) s[n][0] = NEG_INF;
          if (t + 1 >= lim_lo) s[n][1] = NEG_INF;
          if (t >= lim_hi) s[n][2] = NEG_INF;
          if (t + 1 >= lim_hi) s[n][3] = NEG_INF;
        }
      }
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
      }
      mx_lo = quad_max(mx_lo);
      mx_hi = quad_max(mx_hi);
      const float alpha_lo = exp2f((m_lo - mx_lo) * scale_log2);
      const float alpha_hi = exp2f((m_hi - mx_hi) * scale_log2);
      m_lo = mx_lo;
      m_hi = mx_hi;
      const float ms_lo = mx_lo * scale_log2, ms_hi = mx_hi * scale_log2;
      float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        s[n][0] = exp2f(fmaf(s[n][0], scale_log2, -ms_lo));
        s[n][1] = exp2f(fmaf(s[n][1], scale_log2, -ms_lo));
        s[n][2] = exp2f(fmaf(s[n][2], scale_log2, -ms_hi));
        s[n][3] = exp2f(fmaf(s[n][3], scale_log2, -ms_hi));
        rs_lo += s[n][0] + s[n][1];
        rs_hi += s[n][2] + s[n][3];
      }
      l_lo = l_lo * alpha_lo + rs_lo;        // this lane's columns; summed over the quad at the end
      l_hi = l_hi * alpha_hi + rs_hi;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= alpha_lo;
        acc[n][1] *= alpha_lo;
        acc[n][2] *= alpha_hi;
        acc[n][3] *= alpha_hi;
      }
      // O += P V: the S accumulators of key n-tiles 2kk, 2kk + 1 are the A
      // fragment of k-step kk; one ldmatrix.x4.trans gives two d n-tiles
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P
                                   + dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], a, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();                         // stage j % STAGES is free for tile j + 2
  }

  // normalise, stage the warp's 16 rows in its own rows of q_s, then write
  // each row with 16-byte stores
  if (!active) return;
  const float den_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  const float den_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  bf16* os = q_s + wr * P;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * P + n * 8 + 2 * tq) =
        __floats2bfloat162_rn(acc[n][0] / den_lo, acc[n][1] / den_lo);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * P + n * 8 + 2 * tq) =
        __floats2bfloat162_rn(acc[n][2] / den_hi, acc[n][3] / den_hi);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = e / CPR, c = e % CPR;
    if (wr + r < nrows)
      *reinterpret_cast<uint4*>(o + q_off(wr + r) + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * P + c * 8);
  }
}

}  // namespace mma
}  // namespace rt
