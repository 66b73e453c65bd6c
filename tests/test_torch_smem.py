"""Shared-memory budgeting of the CUDA kernels (repro_torch.kernels.smem):
the reference's VMEM cases (tests/test_vmem_and_profiler.py,
tests/test_paged_kernels.py) restated on Hopper's budget, a block's 232448
bytes. That the estimates equal what each library reports of its own
launches is checked on the card (tests/test_torch_cuda.py)."""
import pytest

from repro.kernels import vmem
from repro_torch.kernels import smem


def test_default_kernel_tiles_fit_shared_memory():
    """Every instantiation the launchers reach fits a block, and so does
    each kernel at the serving paths' shapes."""
    for label, _, _, _, est in smem.cases():
        assert est.fits, label
    smem.flash_attention_smem(128).assert_fits("flash_attention")
    smem.decode_attention_smem(1, 128).assert_fits("decode_attention")
    smem.rwkv6_smem(64).assert_fits("rwkv6_wkv")
    smem.mamba2_smem(64, 64).assert_fits("mamba2_ssd")


def test_oversized_tiles_rejected():
    """SSD's 64-token chunk at N = P = 128 is the one that does not fit
    (the kernel halves it, csrc/mamba2_ssd.cu CHUNK_AT)."""
    est = smem.mamba2_smem(128, 128, 64)
    assert not est.fits
    with pytest.raises(ValueError, match="shared-memory"):
        est.assert_fits("mamba2_ssd")
    assert not smem.SmemEstimate(0, smem.STATIC_SMEM_BYTES + 4).fits   # static limit


def test_autotune_block_monotone_and_refuses_when_nothing_fits():
    fit = lambda c: smem.mamba2_smem(128, 128, c)
    best = smem.autotune_block(fit, lo=16, hi=256)
    assert best == 32 and fit(best).fits and not fit(best * 2).fits
    fits = [fit(c).fits for c in (16, 32, 64, 128, 256)]
    assert fits == sorted(fits, reverse=True)        # once it stops fitting, it stays so
    with pytest.raises(ValueError, match="no block size fits"):
        smem.autotune_block(fit, lo=64, hi=256)
    # the chunk each (N, P) launches with: 64 tokens, 32 at N = P = 128
    assert {(n, p): smem.ssd_chunk(n, p) for n in (64, 128) for p in (64, 128)} == {
        (64, 64): 64, (64, 128): 64, (128, 64): 64, (128, 128): 32}


def test_totals_sane():
    e = smem.flash_attention_smem(128)
    assert 0 < e.total_bytes < smem.SMEM_BYTES and e.static_bytes == 0
    assert e.total_bytes == 2 * (128 + 8) * (64 + 2 * 2 * 64)   # Q + two-stage K/V, bf16
    t = smem.rwkv6_smem(64, dtype_bytes=4)                        # the fp32 per-token form
    assert t.dynamic_bytes == 0 and 0 < t.static_bytes <= smem.STATIC_SMEM_BYTES
    assert smem.regs_fit(255, 256) and not smem.regs_fit(256, 128)
    assert not smem.regs_fit(255, 512)                             # 130560 > 65536


def test_paged_prefill_has_no_chunk_limit_on_hopper():
    """The reference refuses a chunk whose query rows overflow VMEM (its
    ops.py: "lower BatchPolicy.chunk_tokens"); the Hopper kernel tiles the
    rows 64 a block, so its shared memory does not depend on the chunk, and
    a context table too long for shared memory is read in place."""
    assert not vmem.paged_prefill_vmem(rows=65536, chunk=8192, block_size=16,
                                       head_dim=128).fits
    for npages in (0, 1, smem.SMEM_TABLE, smem.SMEM_TABLE + 1, 10**6):
        assert smem.paged_prefill_smem(128, npages).fits, npages
    assert smem.paged_prefill_smem(128, 10**6).total_bytes == smem.flash_attention_smem(
        128).total_bytes


def test_paged_decode_limit_is_the_pages_of_a_split():
    """The reference's guard is on group x page size; the Hopper kernel holds
    8 query rows a block and 64-key tiles whatever the page, so that shape
    fits. Its own limit is the page ids of one split: with one split per
    (sequence, kv head) (B x KV >= 132 blocks on 132 SMs) a table of 40000
    pages of 16 no longer fits, and the paged decode's CUDA wrapper refuses
    it before the launch, once its split is known (tests/test_torch_cuda.py)."""
    assert not vmem.paged_decode_vmem(group=64, block_size=16384, head_dim=128).fits
    assert smem.paged_decode_smem(64, 128, 16384, chunk=16384).fits
    assert smem.paged_decode_smem_for(1, 8, 8, 128, 16, 40000, 2, 132).fits   # many splits
    big = smem.paged_decode_smem_for(32, 8, 8, 128, 16, 40000, 2, 132)
    assert not big.fits
    with pytest.raises(ValueError, match="paged_decode_attention: shared-memory"):
        big.assert_fits("paged_decode_attention")
