// One decode step of attention straight off the paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// paged_decode_attention_grouped (body _paged_decode_kernel). It reads one
// layer of PagedKVPool storage, pages (NB + 1, KV, bs, D) with the dump page
// last, through int32 block tables; no gather.
//
// One query token per sequence attends over its `len` cached tokens (mask
// kpos < len) plus the step's own K/V, which is not in the pool yet and is
// merged last, as the TPU kernel's finalize step does. A block owns one
// (kv head, sequence, group of up to 8 query rows) and reads only its
// sequence's table entries below ceil(len / bs), so the dump-padded entries
// are never read.
//
// Bound on the H100: bytes, as for the dense decode (about 2 * G
// operations per byte of K/V); the floor is the K/V bytes of the cached
// tokens over 3.35 TB/s. The block's eight warps split the keys in 32-key
// tiles, stage K in their own shared memory, read V rows from the pages at
// coalesced columns, and merge their softmax states once at the end. The
// TPU kernel walked the pages along a sequential grid axis with its state
// in scratch; a CUDA block cannot carry state across blocks, so it loops.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 8;

template <int DC, int RPW>
constexpr size_t dec_smem_bytes() {
  constexpr int D = DC * 32;
  return sizeof(float) * (RPW * D + RPW + WARPS * TILE * (D + 1));
}

template <typename T, int DC, int RPW>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables, const int* __restrict__ lengths,
                    const T* __restrict__ kn, const T* __restrict__ vn, T* __restrict__ o,
                    int KV, int G, int bs, int NB, float scale) {
  constexpr int D = DC * 32;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [RPW][D]
  float* self_s = q_s + RPW * D;            // [RPW] scores against the step's own key
  float* k_all = self_s + RPW;              // [WARPS][TILE][D + 1], then merge scratch

  const int kvh = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * RPW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrows = min(RPW, G - g0);
  const long q_row0 = ((long)b * KV + kvh) * G + g0;   // row i of q/o at (q_row0 + i) * D
  const long new_off = ((long)b * KV + kvh) * D;       // the step's own k/v row
  const int* tbl = tables + (long)b * NB;
  // token t of this sequence: page tbl[t / bs], slot t % bs
  auto page_off = [&](int t) { return (((long)tbl[t / bs] * KV + kvh) * bs + t % bs) * D; };

  for (int e = threadIdx.x; e < RPW * D; e += blockDim.x)
    q_s[e] = e / D < nrows ? to_f(q[q_row0 * D + e]) : 0.f;
  __syncthreads();
  for (int i = warp; i < nrows; i += WARPS) {
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) part += q_s[i * D + lane + 32 * j] * to_f(kn[new_off + lane + 32 * j]);
    part = warp_sum(part);
    if (lane == 0) self_s[i] = part * scale;
  }

  RowState<DC, RPW> st;
  st.init();
  const int len = min(lengths[b], NB * bs);   // cached tokens: kpos < len
  float* k_s = k_all + warp * TILE * (D + 1);
  for (int t0 = warp * TILE; t0 < len; t0 += WARPS * TILE) {
    const int nk = min(TILE, len - t0);
    __syncwarp();
    load_rows<DC>(k_s, D + 1, kp, [&](int t) { return page_off(t0 + t); }, nk, 0, 1, lane);
    __syncwarp();
    fold_tile<DC, RPW>(
        st, q_s, k_s, nk, [&](int t) { return vp + page_off(t0 + t); }, scale, lane,
        [&](int i, int) { return i < nrows; });
  }
  merge_and_store<DC, RPW, WARPS, T>(st, k_all, nrows, self_s, vn + new_off, o + q_row0 * D,
                                     warp, lane);
}

template <typename T, int DC, int RPW>
int launch_decode(const void* q, const void* kp, const void* vp, const int* tables,
                  const int* lengths, const void* kn, const void* vn, void* o, int B, int KV,
                  int G, int bs, int NB, float scale, cudaStream_t stream) {
  dim3 grid(KV, B, (G + RPW - 1) / RPW);
  return rt_launch(paged_decode_kernel<T, DC, RPW>, grid, dim3(WARPS * 32),
                   dec_smem_bytes<DC, RPW>(), stream, (const T*)q, (const T*)kp,
                   (const T*)vp, tables, lengths, (const T*)kn, (const T*)vn, (T*)o, KV, G,
                   bs, NB, scale);
}

}  // namespace

// q/o (B, KV, G, D); pages (NBp, KV, bs, D); tables (B, NB) int32; lengths
// (B,) int32 cached tokens; k_new/v_new (B, KV, D): the step's own K/V.
// Contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1). Returns a cudaError_t.
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* lengths, const void* kn,
                                   const void* vn, void* o, int B, int KV, int G, int D, int bs,
                                   int NB, int is_bf16, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || bs <= 0 || NB <= 0) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* ln = (const int*)lengths;
  RT_DISPATCH_D(D, RT_DISPATCH_RPW(rt_rows_per_warp(G), return is_bf16
      ? launch_decode<__nv_bfloat16, DC, RPW>(q, kp, vp, tb, ln, kn, vn, o, B, KV, G, bs, NB,
                                              scale, st)
      : launch_decode<float, DC, RPW>(q, kp, vp, tb, ln, kn, vn, o, B, KV, G, bs, NB, scale,
                                      st)));
}
