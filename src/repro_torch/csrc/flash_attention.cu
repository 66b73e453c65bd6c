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
// Bound on the H100: operations. Causal prefill does ~2 * B * H * S^2 * D
// multiply-adds against B * (H + 2 KV) * S * D elements of traffic, so at
// the prompt lengths of serving (hundreds of tokens, D = 128) the work is
// about 100 operations per byte. This first version runs them as fp32 FMAs
// on the CUDA cores, not on the tensor cores, so it sits far under the
// 989 TFLOP/s bf16 bound; its design only keeps the work off device memory:
//   - one block per (64 query rows, head, batch); the 64 rows stay in shared
//     memory as fp32 for the whole key loop, eight rows per warp;
//   - the block loads each 32-key K/V tile once into shared memory (padded
//     rows, conflict-free) and all eight warps fold it into their rows;
//   - m, l and the output accumulators stay in registers; the output is
//     written once. The TPU kernel carried m/l/acc across a sequential grid
//     axis; here the block loops over its keys itself.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 8;
constexpr int RPW = 8;
constexpr int ROWS = WARPS * RPW;   // query rows per block

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * D + TILE * (D + 1) + TILE * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int S, int H, int KV, int causal, float scale) {
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
  store_rows<D, RPW, T>(
      st, [&](int i) { return my0 + i < S ? o + q_off(my0 + i) : (T*)nullptr; }, lane);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           int causal, float scale, cudaStream_t stream) {
  dim3 grid((S + ROWS - 1) / ROWS, H, B);
  return rt_launch(flash_kernel<T, D>, grid, dim3(WARPS * 32), smem_bytes<D>(), stream,
                   (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KV, causal, scale);
}

}  // namespace

// q/o (B, S, H, D), k/v (B, S, KV, D), contiguous, fp32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1). Returns a cudaError_t code; 0 when the launch was taken.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KV, int D, int causal,
                                      int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH_D(D, return is_bf16
      ? launch<__nv_bfloat16, HD>(q, k, v, o, B, S, H, KV, causal, scale, st)
      : launch<float, HD>(q, k, v, o, B, S, H, KV, causal, scale, st));
}
