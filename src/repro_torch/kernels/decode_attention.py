"""Decode attention over a contiguous (dense) KV cache.

`decode_attention` launches the CUDA kernel `csrc/decode_attention.cu` for a
tensor on the card and takes the plain PyTorch version for a tensor on the
CPU. The kernel replaces the TPU kernel `decode_attention_grouped` of
src/repro/kernels/decode_attention.py: one query token per sequence, the
new token already written at slot `pos`, INCLUSIVE mask kpos <= pos, any
cache length S.

`decode_attention_plain` is the reference's dense decode math
(models/attention.py `decode_attention`, non-kernel branch), op for op; the
paged decode's plain version runs it on the page-gathered cache, which keeps
the port's paged path token-identical to its dense path on the CPU.

Both decode kernels (this one and `csrc/paged_decode_attention.cu`) run on
one core, `csrc/decode_core.cuh`, that splits each sequence's keys across
blocks. `decode_splits` picks the split from host-known shapes (no device
tensor is read, so no sync), and `split_launch` gives a launch its split,
partial states and merge tickets.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
KEY_TILE = 64          # keys a decode block folds at a time (decode_core.cuh KT)
# the split aims at this many blocks on each SM: on an H100 every further
# split cost more than the balance it bought (chip_smoke.py times 1, 2, 4)
BLOCKS_PER_SM = 1
MAX_ROWS = 8           # query rows a decode block holds at most

KERNEL = build.CudaKernel(
    "decode_attention", "decode_attention_launch",
    [build.PTR] * 7 + [build.INT] * 8 + [build.PTR])

# merge tickets, one int per (sequence, kv head, row group), by (device,
# stream): zeroed once and left zero by every launch, so a call needs no
# memset of its own; launches on one stream run in order, so they can share
_TICKETS: dict = {}


def rows_per_block(g: int) -> int:
    """Query rows of a kv head a decode block holds: the smallest of 1, 2,
    4, 8 that holds min(g, 8) (decode_core.cuh `rt_rows_per_block`)."""
    r = 1
    while r < g and r < MAX_ROWS:
        r *= 2
    return r


def row_groups(g: int) -> int:
    """Blocks a (sequence, kv head) needs for its g query rows, per split."""
    return -(-g // rows_per_block(g))


def decode_splits(b: int, kv: int, groups: int, max_keys: int,
                  sm_count: int) -> tuple[int, int]:
    """(n, chunk): split i of n covers the keys [i * chunk, min((i + 1) *
    chunk, len)) of each sequence, for any len <= max_keys. chunk is a
    multiple of KEY_TILE, n * chunk >= max_keys and no split starts at or
    past max_keys. n is the most splits, at whole tiles, that keeps
    b * kv * groups * n within BLOCKS_PER_SM * sm_count blocks (at least
    one split)."""
    if min(b, kv, groups, max_keys, sm_count) < 1:
        raise ValueError(f"decode_splits needs positive sizes, got b={b} kv={kv} "
                         f"groups={groups} max_keys={max_keys} sm_count={sm_count}")
    tiles = -(-max_keys // KEY_TILE)
    want = max(BLOCKS_PER_SM * sm_count // (b * kv * groups), 1)
    per = -(-tiles // min(want, tiles))              # tiles a split
    return -(-tiles // per), per * KEY_TILE


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_launch(q, kv: int, max_keys: int):
    """The split of a decode launch for q (B, 1, H, D) over kv heads and at
    most max_keys keys a sequence, on q's device and stream: (n, chunk,
    workspace, tickets). The workspace holds the n partial states of every
    (sequence, kv head, row group), rows_per_block * (D + 2) fp32 each; the
    tickets, one int each, are 0. Both are None when n == 1 (the blocks then
    write the output directly)."""
    b, _, h, d = q.shape
    g = h // kv
    groups = row_groups(g)
    n, chunk = decode_splits(b, kv, groups, max_keys, sm_count(q.device))
    if n == 1:
        return n, chunk, None, None
    pairs = b * kv * groups
    ws = torch.empty(pairs * n * rows_per_block(g) * (d + 2), dtype=torch.float32,
                     device=q.device)
    key = (q.device.index, build.stream_ptr(q))
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < pairs:
        size = pairs if tickets is None else max(pairs, 2 * tickets.numel())
        tickets = _TICKETS[key] = torch.zeros(size, dtype=torch.int32, device=q.device)
    return n, chunk, ws, tickets


def ptr(t) -> int:
    """A tensor's address for ctypes, 0 for None."""
    return 0 if t is None else t.data_ptr()


def decode_attention(q, k_cache, v_cache, pos):
    """q: (B, 1, H, D), caches: (B, KV, S, D), pos: (B,) int -> (B, 1, H, D)."""
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, pos)
    return decode_attention_plain(q, k_cache, v_cache, pos)


def decode_attention_cuda(q, k_cache, v_cache, pos):
    """The hand-written kernel; raises on anything it does not take."""
    if not q.is_cuda:
        raise ValueError("decode_attention_cuda needs CUDA tensors")
    b, _, h, d = q.shape
    _, kvh, s, _ = k_cache.shape
    build.check_float("q", q)
    build.check_head_dim(d)
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    build.check("q", q, (b, 1, h, d), q.dtype, q.device)
    build.check("k_cache", k_cache, (b, kvh, s, d), q.dtype, q.device)
    build.check("v_cache", v_cache, (b, kvh, s, d), q.dtype, q.device)
    build.check("pos", pos, (b,), torch.int32, q.device)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        build.check_aligned(name, t)
    n, chunk, ws, tickets = split_launch(q, kvh, s)
    o = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  pos.data_ptr(), o.data_ptr(), ptr(ws), ptr(tickets), b, kvh,
                  h // kvh, s, d, n, chunk, build.is_bf16(q), build.stream_ptr(q))
    return o


def decode_attention_plain(q, k_cache, v_cache, pos):
    """The plain version: full masked softmax over the cache."""
    b, kvh, smax, d = k_cache.shape
    h = q.shape[2]
    qh = q[:, 0].reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bqgd,bqtd->bqgt", qh, k_cache).float() * (d ** -0.5)
    # slots past pos hold finite garbage (stale tokens, the pool's dump
    # page); this mask is the only thing that excludes them
    mask = torch.arange(smax, device=q.device)[None, :] <= pos[:, None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bqgt,bqtd->bqgd", probs, v_cache)
    return out.reshape(b, 1, h, d)
