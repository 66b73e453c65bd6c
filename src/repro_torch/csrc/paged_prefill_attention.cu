// One chunk of chunked prefill straight off the paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// paged_prefill_attention_fused (body _paged_prefill_kernel). It reads one
// layer of PagedKVPool storage, pages (NB + 1, KV, bs, D) with the dump page
// last, through the sequence's int32 block table; no gather.
//
// C new tokens of one sequence attend over its `ctx` paged tokens (mask
// kpos < ctx) and then over themselves causally (col <= row / G). Query
// rows are token-major per kv head: row r is token r / G, head
// kvh * G + r % G. The TPU kernel held all C * G rows of a kv head in one
// program and its wrapper refused chunks that overflow VMEM; here the rows
// are tiled across blocks, grid (ceil(C * G / 64), KV), so the chunk length
// is bounded only by what the scheduler asks for. Each block streams the
// context pages (skipped when ctx == 0), then the chunk's own K/V, in
// 32-key tiles shared by its eight warps.
//
// Bound on the H100: operations once C * G reaches a few hundred rows
// (about C * G / 2 operations per byte of K/V), bytes below that. Like the
// flash kernel, this first version runs fp32 FMAs on the CUDA cores.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int PF_WARPS = 8;
constexpr int PF_RPW = 8;
constexpr int PF_ROWS = PF_WARPS * PF_RPW;   // query rows per block

template <int DC>
constexpr size_t pf_smem_bytes() {
  constexpr int D = DC * 32;
  return sizeof(float) * (PF_ROWS * D + TILE * (D + 1) + TILE * D);
}

template <typename T, int DC>
__global__ void __launch_bounds__(PF_WARPS * 32)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                     const int* __restrict__ table, int ctx, const T* __restrict__ ks,
                     const T* __restrict__ vs, T* __restrict__ o, int C, int KV, int G, int bs,
                     float scale) {
  constexpr int D = DC * 32;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [PF_ROWS][D]
  float* k_s = q_s + PF_ROWS * D;           // [TILE][D + 1]
  float* v_s = k_s + TILE * (D + 1);        // [TILE][D]

  const int kvh = blockIdx.y, r0 = blockIdx.x * PF_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int CG = C * G;
  const int my0 = r0 + warp * PF_RPW;       // this warp's first query row
  // query row r (token r / G, head kvh * G + r % G) of q/o (C, KV * G, D)
  auto q_off = [&](int r) { return (((long)(r / G) * KV + kvh) * G + r % G) * D; };
  auto ctx_off = [&](int t) { return (((long)table[t / bs] * KV + kvh) * bs + t % bs) * D; };
  auto self_off = [&](int t) { return ((long)t * KV + kvh) * D; };

  for (int r = warp; r < PF_ROWS; r += PF_WARPS) {
#pragma unroll
    for (int j = 0; j < DC; ++j)
      q_s[r * D + lane + 32 * j] = r0 + r < CG ? to_f(q[q_off(r0 + r) + lane + 32 * j]) : 0.f;
  }

  RowState<DC, PF_RPW> st;
  st.init();
  const float* my_q = q_s + warp * PF_RPW * D;
  auto v_tile = [&](int t) { return v_s + t * D; };
  // context pages: visible to every row, ragged tail stops the loop
  for (int t0 = 0; t0 < ctx; t0 += TILE) {
    const int nk = min(TILE, ctx - t0);
    __syncthreads();
    auto off = [&](int t) { return ctx_off(t0 + t); };
    load_rows<DC>(k_s, D + 1, kp, off, nk, warp, PF_WARPS, lane);
    load_rows<DC>(v_s, D, vp, off, nk, warp, PF_WARPS, lane);
    __syncthreads();
    if (my0 < CG)
      fold_tile<DC, PF_RPW>(st, my_q, k_s, nk, v_tile, scale, lane,
                            [&](int i, int) { return my0 + i < CG; });
  }
  // the chunk itself, causal: row r sees chunk token c iff c <= r / G
  const int send = min(C, (min(r0 + PF_ROWS, CG) - 1) / G + 1);
  for (int t0 = 0; t0 < send; t0 += TILE) {
    const int nk = min(TILE, send - t0);
    __syncthreads();
    auto off = [&](int t) { return self_off(t0 + t); };
    load_rows<DC>(k_s, D + 1, ks, off, nk, warp, PF_WARPS, lane);
    load_rows<DC>(v_s, D, vs, off, nk, warp, PF_WARPS, lane);
    __syncthreads();
    if (my0 < CG && t0 <= (my0 + PF_RPW - 1) / G)
      fold_tile<DC, PF_RPW>(st, my_q, k_s, nk, v_tile, scale, lane, [&](int i, int t) {
        const int r = my0 + i;
        return r < CG && t0 + t <= r / G;
      });
  }
  store_rows<DC, PF_RPW, T>(
      st, [&](int i) { return my0 + i < CG ? o + q_off(my0 + i) : (T*)nullptr; }, lane);
}

template <typename T, int DC>
int launch_prefill(const void* q, const void* kp, const void* vp, const int* table, int ctx,
                   const void* ks, const void* vs, void* o, int C, int KV, int G, int bs,
                   float scale, cudaStream_t stream) {
  dim3 grid((C * G + PF_ROWS - 1) / PF_ROWS, KV);
  return rt_launch(paged_prefill_kernel<T, DC>, grid, dim3(PF_WARPS * 32), pf_smem_bytes<DC>(),
                   stream, (const T*)q, (const T*)kp, (const T*)vp, table, ctx, (const T*)ks,
                   (const T*)vs, (T*)o, C, KV, G, bs, scale);
}

}  // namespace

// q/o (C, KV * G, D) token-major; pages (NBp, KV, bs, D); table (NB,) int32
// covering the ctx cached tokens (ctx <= NB * bs, checked by the caller);
// k_self/v_self (C, KV, D). Contiguous, fp32 or bf16. Returns a cudaError_t.
extern "C" int paged_prefill_launch(const void* q, const void* kp, const void* vp,
                                    const void* table, int ctx, const void* ks, const void* vs,
                                    void* o, int C, int KV, int G, int D, int bs, int is_bf16,
                                    void* stream) {
  if (C <= 0 || KV <= 0 || G <= 0 || bs <= 0 || ctx < 0) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)table;
  RT_DISPATCH_D(D, return is_bf16
      ? launch_prefill<__nv_bfloat16, DC>(q, kp, vp, tb, ctx, ks, vs, o, C, KV, G, bs, scale, st)
      : launch_prefill<float, DC>(q, kp, vp, tb, ctx, ks, vs, o, C, KV, G, bs, scale, st));
}
