"""The hand-written CUDA kernels on the card (marker `cuda`).

A CUDA kernel has no CPU mode, so these tests skip without a card; on the
machine with one run them with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version (impl="torch") on the same
CUDA tensors, its wrapper must refuse what the kernel does not take, and the
kernels' front door must refuse an input that requires a gradient (no kernel
has a backward). The training path (use_kernels=False) runs on the card and
reaches no kernel; the serving entry points refuse use_kernels=False there. This file imports
neither JAX nor the reference package: the card's machine has neither.
"""
import itertools

import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fla
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pag
from repro_torch.kernels import rwkv6_wkv as wkv

pytestmark = pytest.mark.cuda

# max|kernel - plain| / max|plain|: fp32 differs in summation order only;
# bf16 plain versions round scores and probabilities to bf16
TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# the recurrences: kernel (per token for fp32 inputs, chunked on the tensor
# cores with error-compensated bf16 operands for bf16 ones) and plain
# version (chunked) both work to fp32 accuracy on the same inputs, so they
# differ in summation order only, over T dependent steps
TOL_REC = 1e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rand(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(a, b, dtype):
    torch.cuda.synchronize()
    err = (a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-6)
    assert err < TOL[dtype], float(err)


# the edges of the tensor-core route's tiles (64 query rows, 16 per warp,
# 64-key tiles, 16-column k-steps): S at and around 1, 16, 64 and 128, one
# and four query heads per kv head, head dims 64, 80 and 128
FLASH_TILE_EDGES = [(s, 2 * g, 2, d) for s, g, d in itertools.product(
    (1, 15, 16, 17, 63, 64, 65, 129), (1, 4), (64, 80, 128))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kv,d", [(77, 8, 8, 128), (33, 8, 2, 64), (130, 16, 2, 32)]
                         + FLASH_TILE_EDGES)
def test_flash_kernel_matches_plain(gen, s, h, kv, d, dtype):
    q, k, v = _rand(gen, 2, s, h, d, dtype=dtype), _rand(gen, 2, s, kv, d, dtype=dtype), \
        _rand(gen, 2, s, kv, d, dtype=dtype)
    before = fla.KERNEL.launches
    _close(ops.flash_attention(q, k, v), ops.flash_attention(q, k, v, impl="torch"), dtype)
    assert fla.KERNEL.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kv,d", [(451, 32, 32, 80), (37, 8, 2, 80)])
def test_flash_kernel_matches_plain_at_head_dim_80(gen, s, h, kv, d, dtype):
    q, k, v = _rand(gen, 2, s, h, d, dtype=dtype), _rand(gen, 2, s, kv, d, dtype=dtype), \
        _rand(gen, 2, s, kv, d, dtype=dtype)
    _close(ops.flash_attention(q, k, v), ops.flash_attention(q, k, v, impl="torch"), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv,g,d", [(4, 1, 128), (2, 4, 64), (2, 8, 128), (1, 12, 32),
                                    (32, 1, 80), (2, 4, 80)])
def test_decode_kernels_match_plain(gen, kv, g, d, dtype):
    b, s, bs, nb = 3, 70, 16, 5
    pos = torch.tensor([0, 37, 69], dtype=torch.int32, device="cuda")
    q = _rand(gen, b, 1, kv * g, d, dtype=dtype)
    kc, vc = _rand(gen, b, kv, s, d, dtype=dtype), _rand(gen, b, kv, s, d, dtype=dtype)
    _close(ops.decode_attention(q, kc, vc, pos),
           ops.decode_attention(q, kc, vc, pos, impl="torch"), dtype)
    kp, vp = _rand(gen, 17, kv, bs, d, dtype=dtype), _rand(gen, 17, kv, bs, d, dtype=dtype)
    tables = torch.randperm(16, generator=gen, device="cuda")[:b * nb].reshape(b, nb).int()
    lens = torch.tensor([0, 33, 79], dtype=torch.int32, device="cuda")
    kn, vn = _rand(gen, b, 1, kv, d, dtype=dtype), _rand(gen, b, 1, kv, d, dtype=dtype)
    args = (q, kp, vp, tables, lens, kn, vn, 80)
    before = pag.DECODE_KERNEL.launches
    _close(ops.paged_decode_attention(*args), ops.paged_decode_attention(*args, impl="torch"),
           dtype)
    assert pag.DECODE_KERNEL.launches == before + 1


# the decodes' split and tile edges (64-key tiles, one to eight splits of a
# sequence at these small grids), every head dim, grouped heads up to two
# row groups (G 16), one and four sequences
DECODE_KEYS = (1, 63, 64, 65, 127, 128, 129, 459)
DECODE_EDGES = list(itertools.product(DECODE_KEYS, (1, 4), (1, 4, 8, 16), (32, 64, 80, 128)))


def _poison_past(x, lengths, value):
    """x (B, KV, S, D) with every slot t >= lengths[b] set to value."""
    t = torch.arange(x.shape[2], device=x.device)[None, None, :, None]
    return x.masked_fill(t >= lengths[:, None, None, None], value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("keys,b,g,d", DECODE_EDGES)
def test_dense_decode_at_split_edges(gen, keys, b, g, d, dtype):
    kv = 2
    s = keys + 3
    pos = torch.tensor([keys - 1, keys // 2, 0, keys - 1][:b], dtype=torch.int32, device="cuda")
    q = _rand(gen, b, 1, kv * g, d, dtype=dtype)
    kc, vc = _rand(gen, b, kv, s, d, dtype=dtype), _rand(gen, b, kv, s, d, dtype=dtype)
    before = dec.KERNEL.launches
    got = ops.decode_attention(q, kc, vc, pos)
    assert dec.KERNEL.launches == before + 1
    _close(got, ops.decode_attention(q, kc, vc, pos, impl="torch"), dtype)
    # bit-identical on a repeat, and with finite poison past pos
    assert torch.equal(ops.decode_attention(q, kc, vc, pos), got)
    kp, vp = _poison_past(kc, pos + 1, 1e4), _poison_past(vc, pos + 1, -1e4)
    assert torch.equal(ops.decode_attention(q, kp, vp, pos), got)


def _paged_case(gen, lengths, kv, g, d, bs, dtype):
    """Pages for `lengths` cached tokens a sequence, dump page last, table
    entries at and past ceil(len / bs) dump-padded, one spare table column,
    and +-1e4 in every slot no sequence may read."""
    b = len(lengths)
    nb = -(-(max(lengths) + 1) // bs) + 1
    nbp = b * nb + 1
    kp, vp = _rand(gen, nbp, kv, bs, d, dtype=dtype), _rand(gen, nbp, kv, bs, d, dtype=dtype)
    tables = torch.randperm(nbp - 1, generator=gen, device="cuda")[:b * nb].reshape(b, nb).int()
    seen = torch.zeros(nbp, bs, dtype=torch.bool, device="cuda")
    for i, n in enumerate(lengths):
        tables[i, -(-n // bs):] = nbp - 1
        slots = tables[i].long()[:, None] * bs + torch.arange(bs, device="cuda")
        seen.view(-1)[slots.view(-1)[:n]] = True
    kp = kp.masked_fill(~seen[:, None, :, None], 1e4)
    vp = vp.masked_fill(~seen[:, None, :, None], -1e4)
    q = _rand(gen, b, 1, kv * g, d, dtype=dtype)
    kn, vn = _rand(gen, b, 1, kv, d, dtype=dtype), _rand(gen, b, 1, kv, d, dtype=dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return (q, kp, vp, tables, lens, kn, vn, max(lengths) + 1), seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("keys,b,g,d", DECODE_EDGES)
def test_paged_decode_at_split_edges(gen, keys, b, g, d, bs, dtype):
    lengths = [keys, 0, keys // 2, keys - 1][:b]      # B 4 holds a length-0 sequence
    args, seen = _paged_case(gen, lengths, 2, g, d, bs, dtype)
    before = pag.DECODE_KERNEL.launches
    got = ops.paged_decode_attention(*args)
    assert pag.DECODE_KERNEL.launches == before + 1
    _close(got, ops.paged_decode_attention(*args, impl="torch"), dtype)
    assert torch.equal(ops.paged_decode_attention(*args), got)
    # the poison is never read: other finite values there change nothing
    q, kp, vp, *rest = args
    kq = kp.masked_fill(~seen[:, None, :, None], -3.0)
    vq = vp.masked_fill(~seen[:, None, :, None], 7.0)
    assert torch.equal(ops.paged_decode_attention(q, kq, vq, *rest), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kv,keys,d", [(4, 32, 459, 128), (1, 32, 459, 128), (4, 16, 463, 128),
                                         (4, 32, 466, 80), (16, 32, 300, 128)])
def test_decodes_at_path_shapes(gen, b, kv, keys, d, dtype):
    """The engine's and zamba2's shapes: several 64-key tiles a split (the
    ring wraps), and at B 16 a single split (512 blocks)."""
    lengths = [keys - 7 * i for i in range(b)]
    pos = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = _rand(gen, b, 1, kv, d, dtype=dtype)
    kc, vc = _rand(gen, b, kv, keys + 1, d, dtype=dtype), _rand(gen, b, kv, keys + 1, d, dtype=dtype)
    got = ops.decode_attention(q, kc, vc, pos)
    _close(got, ops.decode_attention(q, kc, vc, pos, impl="torch"), dtype)
    assert torch.equal(ops.decode_attention(q, kc, vc, pos), got)
    args, _ = _paged_case(gen, lengths, kv, 1, d, 16, dtype)
    got = ops.paged_decode_attention(*args)
    _close(got, ops.paged_decode_attention(*args, impl="torch"), dtype)
    assert torch.equal(ops.paged_decode_attention(*args), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv,g,d", [(8, 8, 128), (24, 1, 64)], ids=["qwen2-vl", "musicgen"])
def test_decodes_at_family_shapes(gen, kv, g, d, dtype):
    """qwen2-vl-72b's 8 query heads a kv head (one block holds all 8 rows)
    and musicgen-medium's head_dim 64, at the families' decode: 4 sequences
    of 451-466 cached tokens."""
    lengths = [466, 460, 456, 451]
    pos = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = _rand(gen, 4, 1, kv * g, d, dtype=dtype)
    kc, vc = _rand(gen, 4, kv, 471, d, dtype=dtype), _rand(gen, 4, kv, 471, d, dtype=dtype)
    before = dec.KERNEL.launches
    got = ops.decode_attention(q, kc, vc, pos)
    assert dec.KERNEL.launches == before + 1
    _close(got, ops.decode_attention(q, kc, vc, pos, impl="torch"), dtype)
    args, _ = _paged_case(gen, lengths, kv, g, d, 16, dtype)
    _close(ops.paged_decode_attention(*args), ops.paged_decode_attention(*args, impl="torch"),
           dtype)


def test_moe_ffn_on_the_card_matches_fp32_on_the_cpu(gen):
    """One MoE layer at qwen2-moe-a2.7b's widths (60 experts top-4, d_ff
    1408, shared 5632), bf16 on the card against fp32 on the CPU from the
    same bf16 weights and input. capacity_factor = E, so no unit drops: a
    routing choice that bf16 flips then moves its own token only, and the
    tokens routed alike on both sides are held to the bf16 limit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.layers import init_moe, moe_ffn

    cfg = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p = init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16)

    def tree(p, fn):
        return {k: tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in p.items()}

    def routes(p, x):
        logits = (x.reshape(-1, x.shape[-1]) @ p["router"].to(x.dtype)).float()
        top = torch.topk(logits.softmax(-1), cfg.moe.top_k, dim=-1).indices
        return top.sort(-1).values.cpu()

    pc = tree(p, lambda t: t.cuda())
    p32 = tree(p, lambda t: t.float())
    got = moe_ffn(pc, x.cuda(), cfg).float().cpu().reshape(-1, cfg.d_model)
    want = moe_ffn(p32, x.float(), cfg32).reshape(-1, cfg.d_model)
    alike = (routes(pc, x.cuda()) == routes(p32, x.float())).all(-1)
    assert alike.float().mean() >= 0.75, alike
    err = (got[alike] - want[alike]).abs().max() / want[alike].abs().max()
    assert err < TOL[torch.bfloat16], float(err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_shared_pages(gen, dtype):
    """Sequences that adopt a donor's pages (refcount > 1) read them through
    their own tables; the pool is poisoned everywhere else."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import AttentionConfig
    from repro_torch.serving.kv_cache import PagedKVPool

    bs, kv, d, share = 16, 4, 128, 48
    cfg = dataclasses.replace(get_config("llama-7b"), num_layers=1,
                              attn=AttentionConfig(4 * kv, kv, d))
    pool = PagedKVPool(cfg, 64, bs, dtype=dtype, device=torch.device("cuda"))
    pool.k.fill_(1e4)
    pool.v.fill_(-1e4)
    lengths = [200, 130, 48, 75]
    pool.allocate(0, lengths[0])
    pool.scatter_chunk(0, _rand(gen, 1, kv, lengths[0], d, dtype=dtype),
                       _rand(gen, 1, kv, lengths[0], d, dtype=dtype), 0)
    for sid, n in enumerate(lengths[1:], 1):
        pool.adopt(sid, pool.seq(0).block_table[: share // bs], share)
        pool.extend(sid, n - share)
        if n > share:
            pool.scatter_chunk(sid, _rand(gen, 1, kv, n - share, d, dtype=dtype),
                               _rand(gen, 1, kv, n - share, d, dtype=dtype), share)
    assert min(pool.block_refs(x) for x in pool.seq(0).block_table[: share // bs]) == 4
    max_len = max(lengths) + 1
    tables = pool.device_tables(list(range(4)), pool.blocks_needed(max_len))
    q = _rand(gen, 4, 1, 4 * kv, d, dtype=dtype)
    kn, vn = _rand(gen, 4, 1, kv, d, dtype=dtype), _rand(gen, 4, 1, kv, d, dtype=dtype)
    args = (q, pool.k[0], pool.v[0], tables,
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), kn, vn, max_len)
    got = ops.paged_decode_attention(*args)
    _close(got, ops.paged_decode_attention(*args, impl="torch"), dtype)
    assert torch.equal(ops.paged_decode_attention(*args), got)


def test_decode_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rand(gen, 2, 1, 4, 128, dtype=torch.bfloat16)
    kc = _rand(gen, 2, 4, 40, 128, dtype=torch.bfloat16)
    pos = torch.tensor([3, 39], dtype=torch.int32, device="cuda")
    off = torch.empty(kc.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:].view(kc.shape)
    with pytest.raises(ValueError, match="16-byte"):
        dec.decode_attention_cuda(q, off, kc, pos)
    with pytest.raises(ValueError, match="dtype"):
        dec.decode_attention_cuda(q, kc.float(), kc, pos)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dec.decode_attention_cuda(q.half(), kc.half(), kc.half(), pos)
    args, _ = _paged_case(gen, [20, 9], 4, 1, 128, 16, torch.bfloat16)
    q, kp, vp, tables, lens, kn, vn, _ = args
    offp = torch.empty(kp.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:].view(kp.shape)
    with pytest.raises(ValueError, match="16-byte"):
        pag.paged_decode_attention_cuda(q, offp, vp, tables, lens, kn, vn)
    offn = torch.empty(kn.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:].view(kn.shape)
    with pytest.raises(ValueError, match="16-byte"):
        pag.paged_decode_attention_cuda(q, kp, vp, tables, lens, offn, vn)
    with pytest.raises(ValueError, match="dtype"):
        pag.paged_decode_attention_cuda(q, kp, vp, tables, lens.long(), kn, vn)
    with pytest.raises(ValueError, match="dtype"):
        pag.paged_decode_attention_cuda(q, kp.float(), vp, tables, lens, kn, vn)
    with pytest.raises(ValueError, match="power of two"):
        pag.paged_decode_attention_cuda(q, kp[:, :, :12].contiguous(), vp[:, :, :12].contiguous(),
                                        tables, lens, kn, vn)


# the edges of the tensor-core route's tiles: chunks of 1, 16, 17 and 65
# tokens over contexts at and around 1, 16 and 64 (a 64-key tile that
# straddles the ctx/chunk boundary and a ragged last page), pages of 8 and
# 16, and G of 1, 4 and 8 (16-row fragments that mix tokens)
PAGED_TILE_EDGES = list(itertools.product((1, 16, 17, 65), (0, 1, 15, 16, 63, 64, 65),
                                          (1, 4, 8), (80, 128), (8, 16)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,ctx,g,d,bs", [(37, 13, 4, 64, 8), (20, 0, 8, 64, 8),
                                         (150, 45, 1, 64, 8), (37, 13, 4, 80, 8)]
                         + PAGED_TILE_EDGES)
def test_paged_prefill_kernel_matches_plain(gen, c, ctx, g, d, bs, dtype):
    kv = 2
    nb = max(-(-ctx // bs), 1)
    kp, vp = _rand(gen, nb + 3, kv, bs, d, dtype=dtype), _rand(gen, nb + 3, kv, bs, d, dtype=dtype)
    table = torch.randperm(nb + 2, generator=gen, device="cuda")[:nb].int()
    # finite poison in every pool slot the chunk must not read: pages off
    # the table, the dump page, and the last page's rows past ctx
    seen = torch.zeros(nb + 3, bs, dtype=torch.bool, device="cuda")
    seen.view(-1)[(table.long()[:, None] * bs + torch.arange(bs, device="cuda")).view(-1)[
        torch.arange(nb * bs, device="cuda") < ctx]] = True
    kp = kp.masked_fill(~seen[:, None, :, None], 1e4)
    vp = vp.masked_fill(~seen[:, None, :, None], -1e4)
    table = table if ctx else table[:0]
    q = _rand(gen, 1, c, kv * g, d, dtype=dtype)
    ks, vs = _rand(gen, 1, c, kv, d, dtype=dtype), _rand(gen, 1, c, kv, d, dtype=dtype)
    args = (q, kp, vp, table, ctx, ks, vs)
    _close(ops.paged_prefill_attention(*args),
           ops.paged_prefill_attention(*args, impl="torch"), dtype)


def _wkv_inputs(gen, b, t, h, n, dtype, state=True):
    r, k, v = (_rand(gen, b, t, h, n, dtype=dtype) * 0.5 for _ in range(3))
    logw = (-torch.exp(_rand(gen, b, t, h, n) * 0.5)).clamp(-8.0, -1e-4)
    u = _rand(gen, h, n) * 0.1
    s0 = _rand(gen, b, h, n, n) * 0.1 if state else None
    return r, k, v, logw, u, s0


def _ssd_inputs(gen, b, t, h, p, n, dtype, state=True):
    x = _rand(gen, b, t, h, p, dtype=dtype) * 0.5
    bm, cm = (_rand(gen, b, t, n, dtype=dtype) * 0.5 for _ in range(2))
    dt = torch.nn.functional.softplus(_rand(gen, b, t, h))
    a_log = torch.log(torch.linspace(1.0, 8.0, h, device="cuda"))
    s0 = _rand(gen, b, h, n, p) * 0.1 if state else None
    return x, bm, cm, dt, a_log, s0


def _close_rec(got, want):
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        err = (a - b.float()).abs().max() / (b.float().abs().max() + 1e-6)
        assert err < TOL_REC, float(err)


# the chunked (bf16) route's edges: WKV's chunk of 16 tokens, SSD's of 64
# (32 at N = P = 128, where the tiles of 64 tokens exceed a block's shared
# memory); state0 on and off
WKV_CHUNK_EDGES = [(2, t, 2, 64, state) for t in (15, 16, 17, 33) for state in (True, False)]
SSD_CHUNK_EDGES = [(2, t, 2, 64, 64, state) for t in (63, 64, 65, 129)
                   for state in (True, False)] + [
                  (2, t, 2, 128, 128, state) for t in (31, 32, 33, 65) for state in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,n,state", [(2, 1, 3, 64, True), (1, 17, 1, 64, True),
                                           (2, 40, 3, 32, False), (4, 451, 4, 64, True),
                                           (1, 16, 2, 16, True), (1, 33, 1, 128, True)]
                         + WKV_CHUNK_EDGES)
def test_wkv_kernel_matches_plain(gen, b, t, h, n, state, dtype):
    args = _wkv_inputs(gen, b, t, h, n, dtype, state)
    before = wkv.KERNEL.launches
    _close_rec(ops.rwkv6_wkv(*args), ops.rwkv6_wkv(*args, impl="torch"))
    assert wkv.KERNEL.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,p,n,state", [(2, 1, 3, 64, 64, True), (1, 17, 1, 64, 64, True),
                                             (2, 40, 3, 32, 16, False),
                                             (4, 451, 4, 64, 64, True),
                                             (1, 16, 2, 16, 128, True)] + SSD_CHUNK_EDGES)
def test_ssd_kernel_matches_plain(gen, b, t, h, p, n, state, dtype):
    args = _ssd_inputs(gen, b, t, h, p, n, dtype, state)
    before = ssd.KERNEL.launches
    _close_rec(ops.mamba2_ssd(*args), ops.mamba2_ssd(*args, impl="torch"))
    assert ssd.KERNEL.launches == before + 1


# one call over T1 + T2 tokens against a call over T1 whose final state
# feeds a call over T2: the split falls inside a chunk, on its edge, and
# past one (both forms: bf16 chunked, fp32 per token)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t1,t2", [(7, 30), (16, 17), (64, 65), (100, 3)])
def test_recurrences_carry_their_state(gen, t1, t2, dtype):
    r, k, v, logw, u, s0 = _wkv_inputs(gen, 2, t1 + t2, 3, 64, dtype)
    y, s = ops.rwkv6_wkv(r, k, v, logw, u, s0)
    y1, s1 = ops.rwkv6_wkv(*(a[:, :t1].contiguous() for a in (r, k, v, logw)), u, s0)
    y2, s2 = ops.rwkv6_wkv(*(a[:, t1:].contiguous() for a in (r, k, v, logw)), u, s1)
    _close_rec((torch.cat([y1, y2], 1), s2), (y, s))
    x, bm, cm, dt, a_log, s0 = _ssd_inputs(gen, 2, t1 + t2, 3, 64, 64, dtype)
    y, s = ops.mamba2_ssd(x, bm, cm, dt, a_log, s0)
    first = (a[:, :t1].contiguous() for a in (x, bm, cm, dt))
    y1, s1 = ops.mamba2_ssd(*first, a_log, s0)
    second = (a[:, t1:].contiguous() for a in (x, bm, cm, dt))
    y2, s2 = ops.mamba2_ssd(*second, a_log, s1)
    _close_rec((torch.cat([y1, y2], 1), s2), (y, s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 17, 130])
def test_recurrences_repeat_bit_identically(gen, t, dtype):
    wargs = _wkv_inputs(gen, 2, t, 3, 64, dtype)
    sargs = _ssd_inputs(gen, 2, t, 3, 64, 64, dtype)
    for fn, args in ((ops.rwkv6_wkv, wargs), (ops.mamba2_ssd, sargs)):
        first, again = fn(*args), fn(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_recurrence_wrappers_refuse_what_the_kernels_do_not_take(gen):
    r, k, v, logw, u, s0 = _wkv_inputs(gen, 1, 8, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        wkv.rwkv6_wkv_cuda(*(a.cpu() for a in (r, k, v, logw, u, s0)))
    with pytest.raises(ValueError, match="logw"):
        wkv.rwkv6_wkv_cuda(r, k, v, logw.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="state0"):
        wkv.rwkv6_wkv_cuda(r, k, v, logw, u, s0[:, :1].contiguous())
    with pytest.raises(ValueError, match="head size"):
        wkv.rwkv6_wkv_cuda(*(a[..., :48].contiguous() for a in (r, k, v, logw, u)))
    with pytest.raises(ValueError, match="contiguous"):
        wkv.rwkv6_wkv_cuda(r, k.transpose(1, 2).contiguous().transpose(1, 2), v, logw, u)
    x, bm, cm, dt, a_log, s0 = _ssd_inputs(gen, 1, 8, 2, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.mamba2_ssd_cuda(*(a.cpu() for a in (x, bm, cm, dt, a_log, s0)))
    with pytest.raises(ValueError, match="dtype"):
        ssd.mamba2_ssd_cuda(x, bm.float(), cm, dt, a_log, s0)
    with pytest.raises(ValueError, match="dt"):
        ssd.mamba2_ssd_cuda(x, bm, cm, dt[:, :4].contiguous(), a_log, s0)
    with pytest.raises(ValueError, match="head channels"):
        ssd.mamba2_ssd_cuda(x[..., :48].contiguous(), bm, cm, dt, a_log)
    # the bf16 routes copy rows in 16-byte pieces: a view one element off a
    # 16-byte boundary is refused, not read misaligned
    def off(a):
        return torch.empty(a.numel() + 1, dtype=a.dtype, device="cuda")[1:].view(a.shape)

    for i, name in enumerate(("r", "k", "v", "logw")):
        args = [r, k, v, logw]
        args[i] = off(args[i])
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte"):
            wkv.rwkv6_wkv_cuda(*args, u)
    for i, name in enumerate(("xh", "b_in", "c_in")):
        args = [x, bm, cm]
        args[i] = off(args[i])
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte"):
            ssd.mamba2_ssd_cuda(*args, dt, a_log, s0)


def test_recurrent_plain_paths_refuse_the_card(gen):
    """The chunked scans (use_kernels=False) are the training path and run
    on the card, equal to the kernels' plain versions; the serving entry
    points of the recurrent families refuse use_kernels=False there."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import backbone
    from repro_torch.models.layers import ExecConfig
    from repro_torch.models.mamba2 import ssd_chunked
    from repro_torch.models.rwkv6 import wkv_chunked

    args = _wkv_inputs(gen, 1, 8, 2, 64, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(wkv_chunked(*args), wkv.wkv_chunked_plain(*args)))
    args = _ssd_inputs(gen, 1, 8, 2, 64, 64, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(ssd_chunked(*args), ssd.ssd_plain(*args)))
    plain = ExecConfig(use_kernels=False)
    for arch in ("rwkv6-7b", "zamba2-2.7b"):
        cfg = get_reduced_config(arch)
        params = backbone.init_params(gen, cfg)
        tokens = torch.zeros(1, 8, dtype=torch.long, device="cuda")
        with pytest.raises(ValueError, match="CPU only"):
            backbone.prefill(params, {"tokens": tokens}, cfg, plain)
        cache = backbone.init_cache(cfg, 1, 16)
        with pytest.raises(ValueError, match="CPU only"):
            backbone.serve_step(params, cache, tokens[:, 0], cfg, plain)
        with pytest.raises(ValueError, match="CPU only"):
            backbone.extend_step(params, cache, tokens[:, :2], cfg, plain)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rand(gen, 1, 16, 4, 128)
    k = _rand(gen, 1, 16, 4, 128)
    with pytest.raises(ValueError, match="contiguous"):
        fla.flash_attention_cuda(q, k.transpose(1, 2).contiguous().transpose(1, 2), k)
    with pytest.raises(ValueError, match="dtype"):
        fla.flash_attention_cuda(q, k.half(), k)
    with pytest.raises(ValueError, match="head_dim"):
        fla.flash_attention_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                 k[..., :48].contiguous())
    pos = torch.zeros(1, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="pos"):
        dec.decode_attention_cuda(q[:, :1], k[:, :1].transpose(1, 2).contiguous(),
                                  k[:, :1].transpose(1, 2).contiguous(), pos)
    with pytest.raises(ValueError, match="CUDA"):
        fla.flash_attention_cuda(q.cpu(), k.cpu(), k.cpu())
    # the bf16 route copies rows in 16-byte pieces: a view one element off
    # a 16-byte boundary is refused, not read misaligned
    kb = k.bfloat16()
    off = torch.empty(kb.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:].view(kb.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fla.flash_attention_cuda(off, kb, kb)
    with pytest.raises(ValueError, match="16-byte"):
        pag.paged_prefill_attention_cuda(off[:, :1], kb.transpose(1, 2).contiguous(),
                                         kb.transpose(1, 2).contiguous(),
                                         torch.zeros(1, dtype=torch.int32, device="cuda"), 0,
                                         kb[:, :1], kb[:, :1])


def test_blocked_path_refuses_the_card(gen):
    """The reference's blocked attention (use_kernels=False) is the training
    path: it runs on the card and equals the plain version. The serving
    entry points and the engine refuse use_kernels=False there."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import backbone
    from repro_torch.models.attention import multihead_attention
    from repro_torch.models.config import AttentionConfig
    from repro_torch.models.layers import ExecConfig
    from repro_torch.serving.engine import ServingEngine

    q = _rand(gen, 1, 8, 4, 32)
    plain = ExecConfig(use_kernels=False, q_block=4)
    got = multihead_attention(q, q, q, AttentionConfig(4, 4, 32), plain)
    _close(got, fla.flash_attention_plain(q, q, q, True), torch.float32)
    cfg = get_reduced_config("yi-6b")
    params = backbone.init_params(gen, cfg)
    tokens = torch.zeros(2, 8, dtype=torch.long, device="cuda")
    cache = backbone.init_cache(cfg, 2, 16)
    pages = torch.zeros(cfg.num_layers, 3, cfg.attn.num_kv_heads, 8, cfg.attn.head_dim,
                        dtype=torch.bfloat16, device="cuda")
    table = torch.full((2, 1), 2, dtype=torch.int32, device="cuda")
    lengths = torch.zeros(2, dtype=torch.int32, device="cuda")
    for call in (lambda: backbone.prefill(params, {"tokens": tokens}, cfg, plain),
                 lambda: backbone.serve_step(params, cache, tokens[:, 0], cfg, plain),
                 lambda: backbone.extend_step(params, cache, tokens[:, :2], cfg, plain),
                 lambda: backbone.serve_step_paged(params, pages, pages, table, lengths,
                                                   tokens[:, 0], cfg, plain, max_len=1),
                 lambda: backbone.prefill_chunk_paged(params, pages, pages, table[0], 0,
                                                      tokens[0], cfg, plain),
                 lambda: ServingEngine(cfg, params, exec_cfg=plain)):
        with pytest.raises(ValueError, match="CPU only"):
            call()


def test_the_front_door_refuses_inputs_that_require_a_gradient(gen):
    """No kernel has a backward pass: an input that requires a gradient
    while autograd records is refused, under either impl; without autograd
    the same call runs."""
    q = _rand(gen, 1, 16, 4, 64, dtype=torch.bfloat16)
    qg = q.clone().requires_grad_()
    for impl in ("auto", "torch"):
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(qg, q, q, impl=impl)
    with torch.no_grad():
        _close(ops.flash_attention(qg, q, q), ops.flash_attention(q, q, q, impl="torch"),
               torch.bfloat16)
    kc = q[:, :8].transpose(1, 2).contiguous()
    pos = torch.full((1,), 7, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(qg[:, :1], kc, kc, pos)
    r, k, v, logw, u, s0 = _wkv_inputs(gen, 1, 8, 2, 64, torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rwkv6_wkv(r.requires_grad_(), k, v, logw, u, s0)
    x, bm, cm, dt, a_log, s0 = _ssd_inputs(gen, 1, 8, 2, 64, 64, torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.mamba2_ssd(x, bm, cm, dt.requires_grad_(), a_log, s0)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-moe-a2.7b", "rwkv6-7b", "zamba2-2.7b",
                                  "musicgen-medium", "qwen2-vl-72b"])
def test_forward_and_loss_run_on_the_card_with_the_training_config(gen, arch):
    """forward and loss_fn with TRAIN_EXEC on the card, in fp32, against the
    same weights and batch on the CPU (the reference's math on both), and
    their gradients; no kernel launches."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import backbone
    from repro_torch.models.layers import TRAIN_EXEC
    from repro_torch.training.data import synthetic_batch, to_device
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_step import value_and_grad

    cfg = get_reduced_config(arch, dtype="float32")
    params = backbone.init_params(gen, cfg)
    host = synthetic_batch(cfg, 2, 40, 0, 0)
    kernels = [fla.KERNEL, dec.KERNEL, wkv.KERNEL, ssd.KERNEL, pag.DECODE_KERNEL,
               pag.PREFILL_KERNEL]
    before = [k.launches for k in kernels]
    loss, grads = value_and_grad(params, to_device(host, "cuda", torch.float32), cfg, TRAIN_EXEC)
    assert [k.launches for k in kernels] == before
    cpu = tree_map(lambda t: t.cpu(), params)
    want, want_g = value_and_grad(cpu, to_device(host, "cpu", torch.float32), cfg, TRAIN_EXEC)
    assert abs(float(loss) - float(want)) < 1e-5 * abs(float(want))
    for g, w in zip(tree_leaves(grads), tree_leaves(want_g)):
        assert torch.isfinite(g).all()
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max()) + 1e-12
    with torch.no_grad():
        logits = backbone.forward(params, to_device(host, "cuda", torch.float32), cfg, TRAIN_EXEC)
    assert logits.shape == (2, 40, cfg.vocab_size) and logits.is_cuda


def test_first_use_build_saves_its_ptxas_log(gen, tmp_path, monkeypatch):
    """A library built at first use (CudaKernel._bind) keeps its ptxas log
    beside it, so a later spill check reads the log of a library it did
    not build."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    fresh = build.CudaKernel(dec.KERNEL.source, dec.KERNEL.symbol, dec.KERNEL.argtypes)
    fresh._bind()
    lib = build._lib_path(dec.KERNEL.source)
    assert lib.parent == tmp_path and lib.exists()
    log = build.ptxas_log(dec.KERNEL.source)
    assert lib.with_suffix(".ptxas.txt").read_text() == log
    assert "Compiling entry function" in log and "spill stores" in log


def test_smem_estimates_equal_what_each_library_reports(gen):
    """kernels/smem.py against each library's own query (common.cuh
    rt_query) for every instantiation its launchers reach: the dynamic
    shared bytes the launcher passes, the static bytes and threads a block,
    and a register count that fits an SM."""
    from repro_torch.kernels import build, smem

    for label, source, symbol, args, est in smem.cases():
        dyn, static, regs, threads = build.query(source, symbol, *args)
        assert (dyn, static, threads) == (est.dynamic_bytes, est.static_bytes,
                                          est.threads), label
        assert smem.regs_fit(regs, threads), (label, regs)


def test_paged_decode_front_door_refuses_a_split_beyond_shared_memory(gen):
    """32 sequences x 8 kv heads fill the card's SMs with one split each, so
    a table of 40000 pages puts 40002 page ids beside the K/V ring: the call
    through the front door is refused before any launch (by the CUDA wrapper,
    once it knows the split), in the reference's words."""
    b, kv, bs, d, nb = 32, 8, 16, 128, 40000
    q = _rand(gen, b, 1, kv, d, dtype=torch.bfloat16)
    pages = _rand(gen, 2, kv, bs, d, dtype=torch.bfloat16)
    tables = torch.zeros(b, nb, dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), 5, dtype=torch.int32, device="cuda")
    new = _rand(gen, b, 1, kv, d, dtype=torch.bfloat16)
    before = pag.DECODE_KERNEL.launches
    with pytest.raises(ValueError, match="paged_decode_attention: shared-memory"):
        ops.paged_decode_attention(q, pages, pages, tables, lengths, new, new, max_len=6)
    assert pag.DECODE_KERNEL.launches == before
