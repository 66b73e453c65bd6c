// One decode step of attention over a contiguous (dense) KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_grouped, body _decode_kernel): one query token per
// sequence against its cache, all G = H / KV query heads of a kv head
// together, with the INCLUSIVE mask kpos <= pos (the new token is already
// written at slot pos). Slots past pos hold finite garbage and are never
// read: the key loop stops at pos.
//
// Layout: q/o (B, KV, G, D) (the model's (B, 1, H, D) viewed grouped),
// caches (B, KV, S, D), pos (B,) int32, all contiguous. Any S.
//
// Bound on the H100: bytes. Each key is read once and used for G heads,
// about 2 * G operations per byte of K/V, far under the card's ~295 bf16
// operations per byte, so the floor is the K/V bytes up to pos over
// 3.35 TB/s. The design spends its effort on reading each byte once:
//   - one block per (kv head, sequence, group of up to 8 rows); the G
//     query rows sit in shared memory as fp32;
//   - the block's eight warps split the keys, 32-key tiles dealt round
//     robin, so eight tiles are in flight per block; each warp stages its
//     K tile in its own shared memory and reads V rows straight from device
//     memory at coalesced columns;
//   - the warps' partial softmax states merge once at the end. The TPU
//     kernel walked the keys along a sequential grid axis with the state in
//     scratch; a CUDA block cannot carry state across blocks, so it loops.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 8;

template <int D, int RPW>
constexpr size_t smem_bytes() {
  return sizeof(float) * (RPW * D + WARPS * TILE * (D + 1));
}

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ pos, T* __restrict__ o, int KV, int G, int S,
              float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // [RPW][D]
  float* k_all = q_s + RPW * D;             // [WARPS][TILE][D + 1], then merge scratch

  const int kvh = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * RPW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrows = min(RPW, G - g0);
  const long q_row0 = ((long)b * KV + kvh) * G + g0;   // row i of q/o at (q_row0 + i) * D
  const long c_row0 = ((long)b * KV + kvh) * S;        // cache row t at (c_row0 + t) * D

  for (int e = threadIdx.x; e < RPW * D; e += blockDim.x)
    q_s[e] = e / D < nrows ? to_f(q[q_row0 * D + e]) : 0.f;
  __syncthreads();

  RowState<cols(D), RPW> st;
  st.init();
  const int kend = min(pos[b] + 1, S);      // inclusive: kpos <= pos
  float* k_s = k_all + warp * TILE * (D + 1);
  for (int t0 = warp * TILE; t0 < kend; t0 += WARPS * TILE) {
    const int nk = min(TILE, kend - t0);
    __syncwarp();
    load_rows<D>(k_s, D + 1, kc, [&](int t) { return (c_row0 + t0 + t) * D; }, nk, 0, 1, lane);
    __syncwarp();
    fold_tile<D, RPW>(
        st, q_s, k_s, nk, [&](int t) { return vc + (c_row0 + t0 + t) * D; }, scale, lane,
        [&](int i, int) { return i < nrows; });
  }
  merge_and_store<D, RPW, WARPS, T>(st, k_all, nrows, nullptr, (const T*)nullptr,
                                     o + q_row0 * D, warp, lane);
}

template <typename T, int D, int RPW>
int launch(const void* q, const void* kc, const void* vc, const int* pos, void* o, int B,
           int KV, int G, int S, float scale, cudaStream_t stream) {
  dim3 grid(KV, B, (G + RPW - 1) / RPW);
  return rt_launch(decode_kernel<T, D, RPW>, grid, dim3(WARPS * 32),
                   smem_bytes<D, RPW>(), stream, (const T*)q, (const T*)kc, (const T*)vc,
                   pos, (T*)o, KV, G, S, scale);
}

}  // namespace

// q/o (B, KV, G, D), k/v caches (B, KV, S, D), pos (B,) int32, contiguous,
// fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1). Returns a cudaError_t code.
extern "C" int decode_attention_launch(const void* q, const void* kc, const void* vc,
                                       const void* pos, void* o, int B, int KV, int G, int S,
                                       int D, int is_bf16, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  const int* p = (const int*)pos;
  RT_DISPATCH_D(D, RT_DISPATCH_RPW(rt_rows_per_warp(G), return is_bf16
      ? launch<__nv_bfloat16, HD, RPW>(q, kc, vc, p, o, B, KV, G, S, scale, st)
      : launch<float, HD, RPW>(q, kc, vc, p, o, B, KV, G, S, scale, st)));
}
