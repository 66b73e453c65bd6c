"""Static shared-memory budgeting for the CUDA kernels; the counterpart of
src/repro/kernels/vmem.py for Hopper.

A TPU core's VMEM budget becomes an SM's limits on the H100: a block may use
at most 232448 bytes of shared memory (csrc/common.cuh MAX_SMEM; above 48 KB
only as dynamic shared memory), static `__shared__` arrays at most 48 KB,
and an SM holds 65536 registers, at most 255 a thread. A launch that asks
for more is refused (`rt_launch` returns cudaErrorInvalidValue) and never
runs. These estimators mirror each kernel's launch configuration, template
argument for template argument, so that a shape can be checked, and a tile
chosen, before any launch and off the card.

Every library also answers the same question itself: `<source>_smem`
(csrc/*.cu) reports the dynamic bytes its launcher passes, the static bytes
and registers that ptxas gave the instantiation, and its threads a block.
`cases()` lists the instantiations on the kernels' paths with their
estimates; chip_smoke.py and tests/test_torch_cuda.py hold the two equal, so
this file and the CUDA constants cannot drift apart.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.build import HEAD_DIMS, STATE_DIMS
from repro_torch.kernels.decode_attention import decode_splits, row_groups, rows_per_block

SMEM_BYTES = 232448             # a block's shared memory on sm_90 (common.cuh MAX_SMEM)
STATIC_SMEM_BYTES = 48 * 1024   # static __shared__ arrays of a kernel
REGS_PER_SM = 65536
REGS_PER_THREAD = 255

# csrc constants the estimates mirror
TILE = 32                       # common.cuh: keys a CUDA-core tile
MMA_ROWS, MMA_KT, MMA_STAGES, MMA_THREADS = 64, 64, 2, 128   # mma_attention.cuh
FOLD_ROWS, FOLD_THREADS = 64, 256          # flash / paged prefill fp32 blocks
SMEM_TABLE = 4096               # paged_prefill_attention.cu: table entries in smem
DEC_WARPS, DEC_KT, DEC_STAGES, DEC_MISC = 8, 64, 3, 64        # decode_core.cuh
WKV_CHUNK, SPLIT_TERMS = 16, 3  # rwkv6_wkv.cu L, SPLIT_TERMS
SSD_CHUNK, SSD_WARPS = 64, 8    # mamba2_ssd.cu CHUNK, WARPS
TOKEN_SPLIT = 4                 # the recurrences' fp32 per-token form: threads a column


@dataclasses.dataclass(frozen=True)
class SmemEstimate:
    """One launch's shared memory: the dynamic bytes its launcher passes and
    the kernel's static `__shared__` bytes; `threads` a block."""

    dynamic_bytes: int
    static_bytes: int = 0
    threads: int = 0

    @property
    def total_bytes(self) -> int:
        return self.dynamic_bytes + self.static_bytes

    @property
    def fits(self) -> bool:
        return self.static_bytes <= STATIC_SMEM_BYTES and self.total_bytes <= SMEM_BYTES

    def assert_fits(self, name: str) -> None:
        if not self.fits:
            raise ValueError(
                f"{name}: shared-memory working set {self.total_bytes / 1024:.1f} KiB "
                f"exceeds the {SMEM_BYTES / 1024:.0f} KiB budget of a block")


def regs_fit(regs_per_thread: int, threads: int) -> bool:
    """Whether one block of `threads` threads at this register count fits an SM."""
    return regs_per_thread <= REGS_PER_THREAD and regs_per_thread * threads <= REGS_PER_SM


# --------------------------------------------------------------- attention
def _mma_bytes(head_dim: int) -> int:
    """mma_attention.cuh smem_bytes<D>: Q staging plus the two-stage K and V
    rings, bf16 rows of D + 8."""
    return 2 * (head_dim + 8) * (MMA_ROWS + 2 * MMA_STAGES * MMA_KT)


def _fold_bytes(head_dim: int) -> int:
    """flash_attention.cu smem_bytes<D> (paged prefill's pf_smem_bytes<D>):
    64 fp32 query rows, a padded key tile and a value tile."""
    return 4 * (FOLD_ROWS * head_dim + TILE * (head_dim + 1) + TILE * head_dim)


def flash_attention_smem(head_dim: int, dtype_bytes: int = 2) -> SmemEstimate:
    """bf16: the tensor-core core; fp32: the CUDA-core fold."""
    if dtype_bytes == 2:
        return SmemEstimate(_mma_bytes(head_dim), threads=MMA_THREADS)
    return SmemEstimate(_fold_bytes(head_dim), threads=FOLD_THREADS)


def paged_prefill_smem(head_dim: int, npages: int, dtype_bytes: int = 2) -> SmemEstimate:
    """The prefill chunk's query rows are tiled 64 a block, so the chunk
    length sets no bound; the bf16 block copies the context's page table
    (npages int32) beside the core when it holds at most 4096 entries."""
    if dtype_bytes == 2:
        table = 4 * npages if npages <= SMEM_TABLE else 0
        return SmemEstimate(_mma_bytes(head_dim) + table, threads=MMA_THREADS)
    return SmemEstimate(_fold_bytes(head_dim), threads=FOLD_THREADS)


def _decode_main(group: int, head_dim: int, dtype_bytes: int) -> int:
    """decode_core.cuh main_bytes<T, D, R>: the K/V ring, reused for the key
    processors' softmax states, whichever is larger."""
    vec = 16 // dtype_bytes
    ch = head_dim // vec
    lanes = 4 if ch <= 4 else 8 if ch <= 8 else 16 if ch <= 16 else 32
    nkp = DEC_WARPS * (32 // lanes)
    ring = DEC_STAGES * 2 * DEC_KT * head_dim * dtype_bytes
    states = nkp * rows_per_block(group) * (head_dim + 2) * 4
    return max(ring, states)


def decode_attention_smem(group: int, head_dim: int, dtype_bytes: int = 2) -> SmemEstimate:
    return SmemEstimate(_decode_main(group, head_dim, dtype_bytes) + DEC_MISC,
                        threads=DEC_WARPS * 32)


def page_ids(chunk: int, block_size: int) -> int:
    """paged_decode_attention.cu: the page ids a split of chunk keys can touch."""
    return chunk // block_size + 2


def paged_decode_smem(group: int, head_dim: int, block_size: int, chunk: int,
                      dtype_bytes: int = 2) -> SmemEstimate:
    """The decode core plus the split's page ids: the keys a split covers
    (the host's `decode_splits`) bound the launch."""
    ids = page_ids(chunk, block_size)
    return SmemEstimate(_decode_main(group, head_dim, dtype_bytes) + DEC_MISC + 4 * ids,
                        threads=DEC_WARPS * 32)


def paged_decode_smem_for(batch: int, kv_heads: int, heads: int, head_dim: int,
                          block_size: int, table_pages: int, dtype_bytes: int,
                          sm_count: int) -> SmemEstimate:
    """The paged decode launch of kernels/paged_attention.py for a batch
    whose block tables hold `table_pages` pages: its split, then its shared
    memory."""
    g = heads // kv_heads
    _, chunk = decode_splits(batch, kv_heads, row_groups(g), table_pages * block_size,
                             sm_count)
    return paged_decode_smem(g, head_dim, block_size, chunk, dtype_bytes)


# ------------------------------------------------------------- recurrences
def rwkv6_smem(n: int, dtype_bytes: int = 2) -> SmemEstimate:
    """bf16: rwkv6_wkv.cu WkvSmem<N> (a two-stage ring of 16-token chunks,
    the split state and operands, the warps' scores); fp32: the per-token
    kernel's static tiles of 2048 / N tokens."""
    if dtype_bytes == 2:
        pb, w, bp, L = n + 8, n // 16, (n // 2 + 31) // 32, WKV_CHUNK
        stage = 2 * 3 * L * pb + 4 * L * n
        size = (2 * stage + 2 * 2 * SPLIT_TERMS * L * pb + 2 * SPLIT_TERMS * n * pb
                + 4 * w * L * (L + 4) + 4 * bp * L + 4 * 2 * n)
        return SmemEstimate(size, threads=2 * n)
    tt = 2048 // n
    return SmemEstimate(0, 4 * (4 * tt * n + n), threads=n * TOKEN_SPLIT)


def mamba2_smem(n: int, p: int, chunk: int = SSD_CHUNK, dtype_bytes: int = 2) -> SmemEstimate:
    """bf16: mamba2_ssd.cu SsdSmem<N, P, LC> for a chunk of LC tokens (a
    two-stage ring of x, B, C and dt, the split operands and state, three
    per-token vectors); fp32: the per-token kernel's static tiles."""
    if dtype_bytes == 2:
        pn, pp, k = n + 8, p + 8, SPLIT_TERMS
        stage = 2 * chunk * pp + 2 * 2 * chunk * pn + 4 * chunk
        size = 2 * stage + 2 * k * chunk * pp + 2 * k * n * pp + 3 * 4 * chunk
        return SmemEstimate(size, threads=SSD_WARPS * 32)
    tt = 32 if (2 * n + p + 2) * 32 * 4 <= 40960 else 16
    return SmemEstimate(0, 4 * tt * (2 * n + p + 2), threads=p * TOKEN_SPLIT)


def ssd_chunk(n: int, p: int) -> int:
    """mamba2_ssd.cu CHUNK_AT<N, P>: the largest of 32 and 64 tokens whose
    tiles fit a block (32 at N = P = 128)."""
    return autotune_block(lambda c: mamba2_smem(n, p, c), lo=SSD_CHUNK // 2, hi=SSD_CHUNK)


def autotune_block(fits_fn, lo: int = 128, hi: int = 4096) -> int:
    """Largest power-of-two block in [lo, hi] whose estimate fits."""
    best = 0
    b = lo
    while b <= hi:
        if fits_fn(b).fits:
            best = b
        b *= 2
    if best == 0:
        raise ValueError("no block size fits shared memory")
    return best


# ----------------------------------------------- the libraries' own answers
DTYPE_BYTES = (2, 4)


def cases():
    """(label, source, C query, its int arguments, estimate) for every
    instantiation the kernels' launchers reach: each head dim and type of
    the attention kernels (the decodes at 1, 2, 4 and 8 rows a block; the
    paged kernels with and without a table or page ids to hold), each state
    size and type of the recurrences, and the SSD timing chunks."""
    out = []
    for d in HEAD_DIMS:
        for tb in DTYPE_BYTES:
            bf = int(tb == 2)
            out.append((f"flash D{d} b{tb}", "flash_attention", "flash_attention_smem",
                        (d, bf), flash_attention_smem(d, tb)))
            for npages in (0, 1, SMEM_TABLE, SMEM_TABLE + 1):
                out.append((f"paged_prefill D{d} b{tb} pages{npages}", "paged_prefill_attention",
                            "paged_prefill_smem", (d, bf, npages),
                            paged_prefill_smem(d, npages, tb)))
            for g in (1, 2, 4, 8):
                out.append((f"decode D{d} G{g} b{tb}", "decode_attention",
                            "decode_attention_smem", (d, g, bf), decode_attention_smem(g, d, tb)))
                for bs, chunk in ((16, 64), (16, 1024), (8, 4096)):
                    out.append((f"paged_decode D{d} G{g} b{tb} bs{bs} chunk{chunk}",
                                "paged_decode_attention", "paged_decode_smem",
                                (d, g, bs, chunk, bf), paged_decode_smem(g, d, bs, chunk, tb)))
    for tb in DTYPE_BYTES:
        bf = int(tb == 2)
        for n in STATE_DIMS:
            out.append((f"wkv N{n} b{tb}", "rwkv6_wkv", "rwkv6_wkv_smem", (n, bf),
                        rwkv6_smem(n, tb)))
            for p in STATE_DIMS:
                out.append((f"ssd N{n} P{p} b{tb}", "mamba2_ssd", "mamba2_ssd_smem", (n, p, bf),
                            mamba2_smem(n, p, ssd_chunk(n, p), tb)))
    for chunk in (32, 64, 128):
        out.append((f"ssd N64 P64 chunk{chunk}", "mamba2_ssd", "mamba2_ssd_chunk_smem",
                    (chunk,), mamba2_smem(64, 64, chunk)))
    return out
