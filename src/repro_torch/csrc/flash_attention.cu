// Causal GQA flash attention over a whole prompt, forward only.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_hsd, body _flash_kernel): the same function, online
// softmax over key tiles with tiles above the causal diagonal skipped.
//
// Layout: the model's own, q/o (B, S, H, D) and k/v (B, S, KV, D), all
// contiguous; query head h reads kv head h / (H / KV). Any S: the ragged
// last query block and key tile are masked here, where the TPU wrapper
// demanded block sizes that divide S.
//
// Bound on the H100: causal prefill does ~2 * B * H * S^2 * D multiply-adds
// against B * (H + 2 KV) * S * D elements of traffic, ~100 operations per
// byte at serving's prompt lengths (hundreds of tokens, D = 128); at the
// path's shapes (one to four prompts of 451 tokens) the bound set by the
// bytes and the one set by the 989 TFLOP/s bf16 rate are both a few
// microseconds, so what the kernel pays is latency: loads that do not
// overlap compute, and too few blocks to fill 132 SMs.
//
// Two routes, by input type:
//   bf16  the tensor-core kernel on the shared core of mma_attention.cuh:
//         one block per (64 query rows, head, sequence), 4 warps of 16 rows,
//         Q in registers, K/V through a two-stage cp.async ring, mma.sync
//         m16n8k16 for S = Q K^T and P V, the softmax on the fragments.
//         Query tiles are walked longest first (the q-tile index is the
//         slowest grid axis, reversed), so the heavy causal tiles start in
//         the first wave. This kernel keeps only its addressing: key row t
//         of (b, kvh) at ((b * S + t) * KV + kvh) * D, queries and keys at
//         the same positions.
//   fp32  the CUDA-core kernel below (common.cuh fold_tile): fp32 FMAs,
//         64 query rows per block as fp32 in shared memory, eight rows per
//         warp, 32-key tiles. Only the tests and chip_smoke.py pass fp32;
//         TF32 tensor-core products would not hold the fp32 limits.
#include "common.cuh"
#include "mma_attention.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 8;
constexpr int RPW = 8;
constexpr int ROWS = WARPS * RPW;   // query rows per block

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * D + TILE * (D + 1) + TILE * D);
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S, int H, int KV,
             int causal, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // [ROWS][D]
  float* k_s = q_s + ROWS * D;              // [TILE][D + 1]
  float* v_s = k_s + TILE * (D + 1);        // [TILE][D]

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * ROWS;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int my0 = r0 + warp * RPW;          // this warp's first query row

  // row s of q/o for head h, row t of k/v for head kvh
  auto q_off = [&](int s) { return ((long)(b * S + s) * H + h) * D; };
  auto kv_off = [&](int t) { return ((long)(b * S + t) * KV + kvh) * D; };

  for (int r = warp; r < ROWS; r += WARPS) {
    const int s = r0 + r;
#pragma unroll
    for (int j = 0; j < cols(D); ++j)
      if (in_head<D>(lane, j))
        q_s[r * D + lane + 32 * j] = s < S ? to_f(q[q_off(s) + lane + 32 * j]) : 0.f;
  }

  RowState<cols(D), RPW> st;
  st.init();
  const int kend = causal ? min(S, r0 + ROWS) : S;
  for (int t0 = 0; t0 < kend; t0 += TILE) {
    const int nk = min(TILE, kend - t0);
    __syncthreads();   // the previous tile is consumed (and q_s is written)
    auto off = [&](int t) { return kv_off(t0 + t); };
    load_rows<D>(k_s, D + 1, k, off, nk, warp, WARPS, lane);
    load_rows<D>(v_s, D, v, off, nk, warp, WARPS, lane);
    __syncthreads();
    // a warp whose rows all precede the tile has nothing to fold
    if (my0 < S && (!causal || t0 <= my0 + RPW - 1)) {
      fold_tile<D, RPW>(
          st, q_s + warp * RPW * D, k_s, nk, [&](int t) { return v_s + t * D; }, scale, lane,
          [&](int i, int t) {
            const int row = my0 + i;
            return row < S && (!causal || t0 + t <= row);
          });
    }
  }
  store_rows<D, RPW, float>(
      st, [&](int i) { return my0 + i < S ? o + q_off(my0 + i) : (float*)nullptr; }, lane);
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int KV, int causal, float scale, cudaStream_t stream) {
  dim3 grid((S + ROWS - 1) / ROWS, H, B);
  return rt_launch(flash_kernel<D>, grid, dim3(WARPS * 32), smem_bytes<D>(), stream,
                   (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, KV,
                   causal, scale);
}

using mma::bf16;

template <int D>
__global__ void __launch_bounds__(mma::THREADS, mma::blocks_per_sm(D))
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int KV,
                 int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * mma::ROWS;   // longest tiles first
  const int nrows = min(mma::ROWS, S - r0);
  const int kvh = h / (H / KV);
  auto q_off = [&](int r) { return ((long)(b * S + r0 + r) * H + h) * D; };
  auto kv_rows = [&](int t, const bf16*& kr, const bf16*& vr) {
    const long off = ((long)(b * S + t) * KV + kvh) * D;
    kr = k + off;
    vr = v + off;
  };
  auto lim = [&](int r) { return causal ? r0 + r + 1 : S; };
  mma::attend<D>(q, o, q_off, nrows, kv_rows, lim, lim(nrows - 1), scale_log2,
                 reinterpret_cast<bf16*>(smem_raw));
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int KV, int causal, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  dim3 grid(H, B, (S + mma::ROWS - 1) / mma::ROWS);
  return rt_launch(flash_mma_kernel<D>, grid, dim3(mma::THREADS), mma::smem_bytes<D>(), stream,
                   (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, H, KV, causal,
                   scale_log2);
}

}  // namespace

// q/o (B, S, H, D), k/v (B, S, KV, D), contiguous, fp32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1; every pointer 16-byte aligned). Returns a cudaError_t
// code; 0 when the launch was taken.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KV, int D, int causal,
                                      int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH_D(D, return is_bf16
      ? launch_bf16<HD>(q, k, v, o, B, S, H, KV, causal, st)
      : launch_fp32<HD>(q, k, v, o, B, S, H, KV, causal, scale, st));
}
