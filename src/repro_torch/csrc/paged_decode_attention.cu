// One decode step of attention straight off the paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// paged_decode_attention_grouped (body _paged_decode_kernel). It reads one
// layer of PagedKVPool storage, pages (NB + 1, KV, bs, D) with the dump page
// last, through int32 block tables; no gather.
//
// One query token per sequence attends over its `len` cached tokens (mask
// kpos < len) plus the step's own K/V, which is not in the pool yet and is
// merged last, as the TPU kernel's finalize step does.
//
// Bound on the H100: bytes, as for the dense decode (about 2 * G
// operations per byte of K/V); the floor is the K/V bytes of the cached
// tokens over 3.35 TB/s. The kernel is the dense decode's core
// (decode_core.cuh: keys split across blocks, about one block an SM; 64-key
// tiles through a three-stage ring of 16-byte cp.async copies; the splits'
// states merged in a fixed order by the last block to finish, then the own
// token) with paged addressing: a block copies its split's page ids into
// shared memory once, before its first copy, and finds key t at slot
// t & (bs - 1) of page ids[(t >> log2 bs) - first page], a shift and a mask
// for the power-of-two page sizes the pool uses (16; the tests 8). It reads
// only table entries below ceil(len / bs), so neither the dump-padded
// entries nor the dump page are ever read, and slots past len in the last
// page are zero-filled, not read.
#include "common.cuh"
#include "decode_core.cuh"

using namespace rt;

namespace {

template <typename T, int D, int R>
__global__ void __launch_bounds__(dec::THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables, const int* __restrict__ lengths,
                    const T* __restrict__ kn, const T* __restrict__ vn, T* __restrict__ o,
                    float* __restrict__ ws, int* __restrict__ tickets, int KV, int G, int bs_log2,
                    int NB, int nsplit, int chunk, float scale) {
  extern __shared__ __align__(16) char smem[];
  int* ids = reinterpret_cast<int*>(smem + dec::smem_bytes<T, D, R>(0));   // the split's page ids
  const int split = blockIdx.x % nsplit, z = blockIdx.x / nsplit;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nrows = min(R, G - z * R);
  const long pair = ((long)b * KV + kvh) * (gridDim.x / nsplit) + z;   // (sequence, kv head, row group)
  const long q_row0 = ((long)b * KV + kvh) * G + z * R;  // row i of q/o at (q_row0 + i) * D
  const long new_off = ((long)b * KV + kvh) * D;         // the step's own k/v row
  const int len = max(min(lengths[b], NB << bs_log2), 0);  // cached tokens: kpos < len
  const int k0 = split * chunk, k1 = min(k0 + chunk, len);
  const int p0 = k0 >> bs_log2;
  const int npages = k1 > k0 ? ((k1 - 1) >> bs_log2) - p0 + 1 : 0;
  for (int j = threadIdx.x; j < npages; j += dec::THREADS) ids[j] = tables[(long)b * NB + p0 + j];
  __syncthreads();
  const int slot_mask = (1 << bs_log2) - 1;
  auto off = [&](int t) {
    return ((((long)ids[(t >> bs_log2) - p0] * KV + kvh) << bs_log2) + (t & slot_mask)) * D;
  };
  dec::attend<T, D, R>(q + q_row0 * D, kp, vp, off, k0, k1, kn + new_off, vn + new_off,
                       o + q_row0 * D, nrows, nsplit, split,
                       ws + pair * nsplit * dec::state_floats(R, D), tickets + pair, scale,
                       smem);
}

// Page ids a split of chunk keys can touch, which a block copies beside the
// decode core's shared memory.
static inline int split_page_ids(int chunk, int bs_log2) { return (chunk >> bs_log2) + 2; }

template <typename T, int D, int R>
int launch(const void* q, const void* kp, const void* vp, const int* tables, const int* lengths,
           const void* kn, const void* vn, void* o, float* ws, int* tickets, int B, int KV, int G,
           int bs_log2, int NB, int nsplit, int chunk, float scale, cudaStream_t stream) {
  dim3 grid(nsplit * ((G + R - 1) / R), KV, B);
  const int ids = split_page_ids(chunk, bs_log2);
  return rt_launch(paged_decode_kernel<T, D, R>, grid, dim3(dec::THREADS),
                   dec::smem_bytes<T, D, R>(ids), stream, (const T*)q, (const T*)kp,
                   (const T*)vp, tables, lengths, (const T*)kn, (const T*)vn, (T*)o, ws, tickets,
                   KV, G, bs_log2, NB, nsplit, chunk, scale);
}

}  // namespace

// q/o (B, KV, G, D); pages (NBp, KV, bs, D) with bs a power of two; tables
// (B, NB) int32; lengths (B,) int32 cached tokens; k_new/v_new (B, KV, D):
// the step's own K/V. Contiguous, 16-byte aligned, fp32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1). The keys go to nsplit splits of chunk keys
// (nsplit * chunk >= NB * bs); ws and tickets as for
// decode_attention_launch. Returns a cudaError_t code.
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* lengths, const void* kn,
                                   const void* vn, void* o, void* ws, void* tickets, int B, int KV,
                                   int G, int D, int bs, int NB, int nsplit, int chunk,
                                   int is_bf16, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || bs <= 0 || (bs & (bs - 1)) || NB <= 0 || nsplit <= 0
      || chunk <= 0 || (long)nsplit * chunk < (long)NB * bs
      || (nsplit > 1 && (!ws || !tickets)))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(kp) || !aligned16(vp) || !aligned16(kn) || !aligned16(vn)
      || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  int bs_log2 = 0;
  while ((1 << bs_log2) < bs) ++bs_log2;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* ln = (const int*)lengths;
  float* w = (float*)ws;
  int* tk = (int*)tickets;
  RT_DISPATCH_D(D, RT_DISPATCH_R(rt_rows_per_block(G), return is_bf16
      ? launch<__nv_bfloat16, HD, R>(q, kp, vp, tb, ln, kn, vn, o, w, tk, B, KV, G, bs_log2, NB,
                                     nsplit, chunk, scale, st)
      : launch<float, HD, R>(q, kp, vp, tb, ln, kn, vn, o, w, tk, B, KV, G, bs_log2, NB,
                             nsplit, chunk, scale, st)));
}

// The launch configuration at head dim D for G query rows a kv head, pages
// of bs tokens (a power of two) and splits of chunk keys, bf16 or fp32
// (common.cuh rt_query): the host's split sets the page ids a block holds.
extern "C" int paged_decode_smem(int D, int G, int bs, int chunk, int is_bf16, long long* out) {
  if (G <= 0 || bs <= 0 || (bs & (bs - 1)) || chunk <= 0) return (int)cudaErrorInvalidValue;
  int bs_log2 = 0;
  while ((1 << bs_log2) < bs) ++bs_log2;
  const int ids = split_page_ids(chunk, bs_log2);
  RT_DISPATCH_D(D, RT_DISPATCH_R(rt_rows_per_block(G), return is_bf16
      ? rt_query(paged_decode_kernel<__nv_bfloat16, HD, R>,
                 dec::smem_bytes<__nv_bfloat16, HD, R>(ids), dec::THREADS, out)
      : rt_query(paged_decode_kernel<float, HD, R>, dec::smem_bytes<float, HD, R>(ids),
                 dec::THREADS, out)));
}
