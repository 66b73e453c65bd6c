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
// are tiled across blocks of 64, so the chunk length is bounded only by
// what the scheduler asks for.
//
// Bound on the H100: operations once C * G reaches a few hundred rows
// (about C * G / 2 operations per byte of K/V), bytes below that; at the
// path's shapes (a chunk of ~200 tokens over ~250 cached) both bounds are a
// few microseconds and the kernel pays latency, as flash does.
//
// Two routes, by input type:
//   bf16  the tensor-core kernel on the shared core of mma_attention.cuh
//         (mma.sync bf16 products, Q in registers, a two-stage cp.async ring
//         of 64-key tiles), grid (KV, ceil(C * G / 64)) with the row tiles
//         walked longest first. It sees one key index space [0, ctx + C):
//         key t < ctx is row t % bs of page table[t / bs] (the block copies
//         the table into shared memory once, or reads it in place when it is
//         too long to fit), key t >= ctx is chunk row t - ctx, and row r
//         sees key t iff t < ctx + r / G + 1. So one loop walks context and
//         chunk; a tile that straddles the ctx/chunk boundary or ends past
//         the block's last key is zero-filled and masked.
//   fp32  the CUDA-core kernel below (common.cuh fold_tile): fp32 FMAs,
//         64 rows per block in eight warps, the context pages then the
//         chunk in 32-key tiles. Only the tests and chip_smoke.py pass fp32.
#include "common.cuh"
#include "mma_attention.cuh"

using namespace rt;

namespace {

constexpr int PF_WARPS = 8;
constexpr int PF_RPW = 8;
constexpr int PF_ROWS = PF_WARPS * PF_RPW;   // query rows per block

template <int D>
constexpr size_t pf_smem_bytes() {
  return sizeof(float) * (PF_ROWS * D + TILE * (D + 1) + TILE * D);
}

template <int D>
__global__ void __launch_bounds__(PF_WARPS * 32)
paged_prefill_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                     const float* __restrict__ vp, const int* __restrict__ table, int ctx,
                     const float* __restrict__ ks, const float* __restrict__ vs,
                     float* __restrict__ o, int C, int KV, int G, int bs, float scale) {
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
    for (int j = 0; j < cols(D); ++j)
      if (in_head<D>(lane, j))
        q_s[r * D + lane + 32 * j] = r0 + r < CG ? to_f(q[q_off(r0 + r) + lane + 32 * j]) : 0.f;
  }

  RowState<cols(D), PF_RPW> st;
  st.init();
  const float* my_q = q_s + warp * PF_RPW * D;
  auto v_tile = [&](int t) { return v_s + t * D; };
  // context pages: visible to every row, ragged tail stops the loop
  for (int t0 = 0; t0 < ctx; t0 += TILE) {
    const int nk = min(TILE, ctx - t0);
    __syncthreads();
    auto off = [&](int t) { return ctx_off(t0 + t); };
    load_rows<D>(k_s, D + 1, kp, off, nk, warp, PF_WARPS, lane);
    load_rows<D>(v_s, D, vp, off, nk, warp, PF_WARPS, lane);
    __syncthreads();
    if (my0 < CG)
      fold_tile<D, PF_RPW>(st, my_q, k_s, nk, v_tile, scale, lane,
                            [&](int i, int) { return my0 + i < CG; });
  }
  // the chunk itself, causal: row r sees chunk token c iff c <= r / G
  const int send = min(C, (min(r0 + PF_ROWS, CG) - 1) / G + 1);
  for (int t0 = 0; t0 < send; t0 += TILE) {
    const int nk = min(TILE, send - t0);
    __syncthreads();
    auto off = [&](int t) { return self_off(t0 + t); };
    load_rows<D>(k_s, D + 1, ks, off, nk, warp, PF_WARPS, lane);
    load_rows<D>(v_s, D, vs, off, nk, warp, PF_WARPS, lane);
    __syncthreads();
    if (my0 < CG && t0 <= (my0 + PF_RPW - 1) / G)
      fold_tile<D, PF_RPW>(st, my_q, k_s, nk, v_tile, scale, lane, [&](int i, int t) {
        const int r = my0 + i;
        return r < CG && t0 + t <= r / G;
      });
  }
  store_rows<D, PF_RPW, float>(
      st, [&](int i) { return my0 + i < CG ? o + q_off(my0 + i) : (float*)nullptr; }, lane);
}

template <int D>
int launch_fp32(const void* q, const void* kp, const void* vp, const int* table, int ctx,
                const void* ks, const void* vs, void* o, int C, int KV, int G, int bs,
                float scale, cudaStream_t stream) {
  dim3 grid((C * G + PF_ROWS - 1) / PF_ROWS, KV);
  return rt_launch(paged_prefill_kernel<D>, grid, dim3(PF_WARPS * 32),
                   pf_smem_bytes<D>(), stream, (const float*)q, (const float*)kp,
                   (const float*)vp, table, ctx, (const float*)ks, (const float*)vs, (float*)o,
                   C, KV, G, bs, scale);
}

using mma::bf16;

// Block-table entries a block copies into shared memory (16 KB, so two
// blocks still fit on an SM at D = 128); a longer table is read in place.
constexpr int SMEM_TABLE = 4096;

// Dynamic shared memory of the bf16 kernel: the core's, then the table of a
// context of npages pages when it fits.
template <int D>
size_t mma_smem(int npages) {
  return mma::smem_bytes<D>() + sizeof(int) * (npages <= SMEM_TABLE ? npages : 0);
}

template <int D>
__global__ void __launch_bounds__(mma::THREADS, mma::blocks_per_sm(D))
paged_prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                         const bf16* __restrict__ vp, const int* __restrict__ table, int ctx,
                         const bf16* __restrict__ ks, const bf16* __restrict__ vs,
                         bf16* __restrict__ o, int C, int KV, int G, int bs, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * mma::ROWS;   // longest tiles first
  const int nrows = min(mma::ROWS, C * G - r0);
  const int npages = (ctx + bs - 1) / bs;
  const int* tbl = table;
  if (npages <= SMEM_TABLE) {
    int* tbl_s = reinterpret_cast<int*>(smem_raw + mma::smem_bytes<D>());
    for (int i = threadIdx.x; i < npages; i += mma::THREADS) tbl_s[i] = table[i];
    __syncthreads();
    tbl = tbl_s;
  }
  // block row r: token (r0 + r) / G, head kvh * G + (r0 + r) % G of q/o (C, KV * G, D)
  auto q_off = [&](int r) {
    const int row = r0 + r;
    return (((long)(row / G) * KV + kvh) * G + row % G) * D;
  };
  auto kv_rows = [&](int t, const bf16*& kr, const bf16*& vr) {
    if (t < ctx) {
      const long off = (((long)tbl[t / bs] * KV + kvh) * bs + t % bs) * D;
      kr = kp + off;
      vr = vp + off;
    } else {
      const long off = ((long)(t - ctx) * KV + kvh) * D;
      kr = ks + off;
      vr = vs + off;
    }
  };
  auto lim = [&](int r) { return ctx + (r0 + r) / G + 1; };
  mma::attend<D>(q, o, q_off, nrows, kv_rows, lim, lim(nrows - 1), scale_log2,
                 reinterpret_cast<bf16*>(smem_raw));
}

template <int D>
int launch_bf16(const void* q, const void* kp, const void* vp, const int* table, int ctx,
                const void* ks, const void* vs, void* o, int C, int KV, int G, int bs,
                cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(kp) || !aligned16(vp) || !aligned16(ks)
      || !aligned16(vs) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const size_t smem = mma_smem<D>((ctx + bs - 1) / bs);
  dim3 grid(KV, (C * G + mma::ROWS - 1) / mma::ROWS);
  return rt_launch(paged_prefill_mma_kernel<D>, grid, dim3(mma::THREADS), smem, stream,
                   (const bf16*)q, (const bf16*)kp, (const bf16*)vp, table, ctx,
                   (const bf16*)ks, (const bf16*)vs, (bf16*)o, C, KV, G, bs, scale_log2);
}

}  // namespace

// q/o (C, KV * G, D) token-major; pages (NBp, KV, bs, D); table (NB,) int32
// covering the ctx cached tokens (ctx <= NB * bs, checked by the caller);
// k_self/v_self (C, KV, D). Contiguous, fp32 or bf16 (then every pointer
// 16-byte aligned). Returns a cudaError_t.
extern "C" int paged_prefill_launch(const void* q, const void* kp, const void* vp,
                                    const void* table, int ctx, const void* ks, const void* vs,
                                    void* o, int C, int KV, int G, int D, int bs, int is_bf16,
                                    void* stream) {
  if (C <= 0 || KV <= 0 || G <= 0 || bs <= 0 || ctx < 0) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)table;
  RT_DISPATCH_D(D, return is_bf16
      ? launch_bf16<HD>(q, kp, vp, tb, ctx, ks, vs, o, C, KV, G, bs, st)
      : launch_fp32<HD>(q, kp, vp, tb, ctx, ks, vs, o, C, KV, G, bs, scale, st));
}

// The launch configuration at head dim D over a context of npages pages,
// bf16 or fp32 (common.cuh rt_query). The chunk's rows are tiled 64 a block:
// its length changes nothing here.
extern "C" int paged_prefill_smem(int D, int is_bf16, int npages, long long* out) {
  if (npages < 0) return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D(D, return is_bf16
      ? rt_query(paged_prefill_mma_kernel<HD>, mma_smem<HD>(npages), mma::THREADS, out)
      : rt_query(paged_prefill_kernel<HD>, pf_smem_bytes<HD>(), PF_WARPS * 32, out));
}
