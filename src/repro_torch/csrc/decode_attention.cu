// One decode step of attention over a contiguous (dense) KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_grouped, body _decode_kernel): one query token per
// sequence against its cache, all G = H / KV query heads of a kv head
// together, with the INCLUSIVE mask kpos <= pos (the new token is already
// written at slot pos). Slots past pos hold finite garbage and are never
// read: the keys stop at pos.
//
// Layout: q/o (B, KV, G, D) (the model's (B, 1, H, D) viewed grouped),
// caches (B, KV, S, D), pos (B,) int32, all contiguous. Any S.
//
// Bound on the H100: bytes. Each key is read once and used for G heads,
// about 2 * G operations per byte of K/V, so the floor is the K/V bytes up
// to pos over 3.35 TB/s (7.4 us at llama-7b's 4 sequences of 295-459
// tokens). The shared core (decode_core.cuh) spends its effort on bytes in
// flight: the keys are split across blocks so that about one block runs on
// each SM even at one sequence (32 kv heads x 4 splits), each block of eight
// warps streams its 64-key K/V tiles through a three-stage ring of 16-byte
// cp.async copies, and the splits' partial softmax states merge in a fixed
// order in the last block to finish. The TPU kernel walked the keys along a
// sequential grid axis with its state in scratch; here a block loops over
// its split's tiles and the splits meet through the workspace.
#include "common.cuh"
#include "decode_core.cuh"

using namespace rt;

namespace {

template <typename T, int D, int R>
__global__ void __launch_bounds__(dec::THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ pos, T* __restrict__ o, float* __restrict__ ws,
              int* __restrict__ tickets, int KV, int G, int S, int nsplit, int chunk,
              float scale) {
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x % nsplit, z = blockIdx.x / nsplit;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nrows = min(R, G - z * R);
  const long pair = ((long)b * KV + kvh) * (gridDim.x / nsplit) + z;   // (sequence, kv head, row group)
  const long q_row0 = ((long)b * KV + kvh) * G + z * R;  // row i of q/o at (q_row0 + i) * D
  const long c_row0 = ((long)b * KV + kvh) * S;          // cache row t at (c_row0 + t) * D
  const int len = min(pos[b] + 1, S);                    // inclusive: kpos <= pos
  const int k0 = split * chunk, k1 = min(k0 + chunk, len);
  dec::attend<T, D, R>(
      q + q_row0 * D, kc, vc, [&](int t) { return (c_row0 + t) * D; }, k0, k1, (const T*)nullptr,
      (const T*)nullptr, o + q_row0 * D, nrows, nsplit, split,
      ws + pair * nsplit * dec::state_floats(R, D), tickets + pair, scale, smem);
}

template <typename T, int D, int R>
int launch(const void* q, const void* kc, const void* vc, const int* pos, void* o, float* ws,
           int* tickets, int B, int KV, int G, int S, int nsplit, int chunk, float scale,
           cudaStream_t stream) {
  dim3 grid(nsplit * ((G + R - 1) / R), KV, B);
  return rt_launch(decode_kernel<T, D, R>, grid, dim3(dec::THREADS),
                   dec::smem_bytes<T, D, R>(0), stream, (const T*)q, (const T*)kc,
                   (const T*)vc, pos, (T*)o, ws, tickets, KV, G, S, nsplit, chunk, scale);
}

}  // namespace

// q/o (B, KV, G, D), k/v caches (B, KV, S, D), pos (B,) int32, contiguous,
// 16-byte aligned, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1). The keys go to
// nsplit splits of chunk keys (nsplit * chunk >= S); with nsplit > 1, ws
// holds B * KV * ceil(G / R) * nsplit partial states of R * (D + 2) floats
// and tickets as many ints, all 0 (the kernel leaves them 0). Returns a
// cudaError_t code.
extern "C" int decode_attention_launch(const void* q, const void* kc, const void* vc,
                                       const void* pos, void* o, void* ws, void* tickets, int B,
                                       int KV, int G, int S, int D, int nsplit, int chunk,
                                       int is_bf16, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || S <= 0 || nsplit <= 0 || chunk <= 0
      || (long)nsplit * chunk < S || (nsplit > 1 && (!ws || !tickets)))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(kc) || !aligned16(vc) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  const int* p = (const int*)pos;
  float* w = (float*)ws;
  int* tk = (int*)tickets;
  RT_DISPATCH_D(D, RT_DISPATCH_R(rt_rows_per_block(G), return is_bf16
      ? launch<__nv_bfloat16, HD, R>(q, kc, vc, p, o, w, tk, B, KV, G, S, nsplit, chunk,
                                     scale, st)
      : launch<float, HD, R>(q, kc, vc, p, o, w, tk, B, KV, G, S, nsplit, chunk, scale,
                             st)));
}
