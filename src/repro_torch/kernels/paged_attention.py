"""Paged attention straight off `PagedKVPool` storage: decode and chunked
prefill.

Both functions read ONE layer of the pool, pages (NB + 1, KV, bs, D) with
the dump page last, through int32 block tables. On a CUDA tensor they
launch the kernels of `csrc/paged_decode_attention.cu` and
`csrc/paged_prefill_attention.cu`, which replace the TPU
kernels `paged_decode_attention_grouped` and `paged_prefill_attention_fused`
of src/repro/kernels/paged_attention.py; on a CPU tensor they take the plain
versions, which follow the reference's jnp twins (src/repro/kernels/ops.py
`_paged_decode_jnp` and the prefill twin) op for op: gather the pages, then
run the dense decode / prefill math. That keeps the port's paged engine path
token-identical to its dense path on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import attend_block

DECODE_KERNEL = build.CudaKernel(
    "paged_decode_attention", "paged_decode_launch",
    [build.PTR] * 10 + [build.INT] * 9 + [build.PTR])
PREFILL_KERNEL = build.CudaKernel(
    "paged_prefill_attention", "paged_prefill_launch",
    [build.PTR] * 4 + [build.INT] + [build.PTR] * 3 + [build.INT] * 6
    + [build.PTR])


# --------------------------------------------------------------------- decode
def paged_decode_attention(q, k_pages, v_pages, tables, lengths, k_new, v_new,
                           max_len: int):
    """One decode step. q: (B, 1, H, D); k/v_pages: (NBp, KV, bs, D);
    tables: (B, NB) int32 dump-padded; lengths: (B,) cached tokens (the new
    token's position); k/v_new: (B, 1, KV, D) the step's own K/V, not yet
    in the pool; max_len: batch-max length including the new token (the
    plain version's gather width) -> (B, 1, H, D)."""
    if q.is_cuda:
        return paged_decode_attention_cuda(q, k_pages, v_pages, tables, lengths,
                                           k_new, v_new)
    return paged_decode_attention_plain(q, k_pages, v_pages, tables, lengths,
                                        k_new, v_new, max_len)


def paged_decode_attention_cuda(q, k_pages, v_pages, tables, lengths, k_new,
                                v_new):
    """The hand-written kernel; raises on anything it does not take. The
    keys are split for a table's full width, tables.shape[1] * bs tokens
    (the kernel clamps every length to it, so the splits cover every key
    whatever the lengths hold); the caller's max_len is only the plain
    version's gather width."""
    if not q.is_cuda:
        raise ValueError("paged_decode_attention_cuda needs CUDA tensors")
    b, _, h, d = q.shape
    nbp, kvh, bs, _ = k_pages.shape
    nb = tables.shape[1]
    build.check_float("q", q)
    build.check_head_dim(d)
    if h % kvh or nb < 1:
        raise ValueError(f"bad grouping {h}/{kvh} or empty tables {tuple(tables.shape)}")
    if bs & (bs - 1):
        raise ValueError(f"page size {bs} is not a power of two")
    build.check("q", q, (b, 1, h, d), q.dtype, q.device)
    build.check("k_pages", k_pages, (nbp, kvh, bs, d), q.dtype, q.device)
    build.check("v_pages", v_pages, (nbp, kvh, bs, d), q.dtype, q.device)
    build.check("tables", tables, (b, nb), torch.int32, q.device)
    build.check("lengths", lengths, (b,), torch.int32, q.device)
    build.check("k_new", k_new, (b, 1, kvh, d), q.dtype, q.device)
    build.check("v_new", v_new, (b, 1, kvh, d), q.dtype, q.device)
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_new", k_new), ("v_new", v_new)):
        build.check_aligned(name, t)
    n, chunk, ws, tickets = dec.split_launch(q, kvh, nb * bs)
    o = torch.empty_like(q)
    DECODE_KERNEL.launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), o.data_ptr(),
        dec.ptr(ws), dec.ptr(tickets), b, kvh, h // kvh, d, bs, nb, n, chunk,
        build.is_bf16(q), build.stream_ptr(q))
    return o


def paged_decode_attention_plain(q, k_pages, v_pages, tables, lengths, k_new,
                                 v_new, max_len: int):
    """Gather the table pages contiguous (max_len wide), write the new token
    at its `lengths` slot, run the dense decode math (mask <= lengths)."""
    b = q.shape[0]
    kvh, bs, d = k_pages.shape[1:]
    nb = tables.shape[1]
    rows = torch.arange(b, device=q.device)

    def densify(pages, new):
        got = pages[tables.long()]                       # (B, NB, KV, bs, D)
        cache = got.transpose(1, 2).reshape(b, kvh, nb * bs, d)
        cache = cache[:, :, :max_len].contiguous()
        cache[rows, :, lengths.long()] = new[:, 0]
        return cache

    return decode_attention_plain(q, densify(k_pages, k_new),
                                  densify(v_pages, v_new), lengths)


# -------------------------------------------------------------------- prefill
def paged_prefill_attention(q, k_pages, v_pages, table, ctx: int, k_self,
                            v_self):
    """One prefill chunk of one sequence. q: (1, C, H, D); k/v_pages:
    (NBp, KV, bs, D); table: (NB,) int32 covering the `ctx` cached tokens;
    k/v_self: (1, C, KV, D) the chunk's own K/V -> (1, C, H, D)."""
    if q.is_cuda:
        return paged_prefill_attention_cuda(q, k_pages, v_pages, table, ctx,
                                            k_self, v_self)
    return paged_prefill_attention_plain(q, k_pages, v_pages, table, ctx,
                                         k_self, v_self)


def paged_prefill_attention_cuda(q, k_pages, v_pages, table, ctx: int, k_self,
                                 v_self):
    """The hand-written kernel; raises on anything it does not take."""
    if not q.is_cuda:
        raise ValueError("paged_prefill_attention_cuda needs CUDA tensors")
    _, c, h, d = q.shape
    nbp, kvh, bs, _ = k_pages.shape
    nb = table.shape[0]
    build.check_float("q", q)
    build.check_head_dim(d)
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if not 0 <= ctx <= nb * bs:
        raise ValueError(f"ctx {ctx} outside the table's {nb} pages of {bs}")
    build.check("q", q, (1, c, h, d), q.dtype, q.device)
    build.check("k_pages", k_pages, (nbp, kvh, bs, d), q.dtype, q.device)
    build.check("v_pages", v_pages, (nbp, kvh, bs, d), q.dtype, q.device)
    build.check("table", table, (nb,), torch.int32, q.device)
    build.check("k_self", k_self, (1, c, kvh, d), q.dtype, q.device)
    build.check("v_self", v_self, (1, c, kvh, d), q.dtype, q.device)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                        ("k_self", k_self), ("v_self", v_self)):
            build.check_aligned(name, t)
    o = torch.empty_like(q)
    PREFILL_KERNEL.launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        int(ctx), k_self.data_ptr(), v_self.data_ptr(), o.data_ptr(),
        c, kvh, h // kvh, d, bs, build.is_bf16(q), build.stream_ptr(q))
    return o


def paged_prefill_attention_plain(q, k_pages, v_pages, table, ctx: int, k_self,
                                  v_self):
    """One `attend_block` over [gathered context ; chunk] with the chunk's
    global offset, the reference's prefill twin."""
    kvh, bs, d = k_pages.shape[1:]
    nb = table.shape[0]

    def densify(pages):
        got = pages[table.long()]                        # (NB, KV, bs, D)
        return got.transpose(1, 2).reshape(nb * bs, kvh, d)[:ctx]

    kc = torch.cat([densify(k_pages), k_self[0]], dim=0)[None]
    vc = torch.cat([densify(v_pages), v_self[0]], dim=0)[None]
    return attend_block(q, kc, vc, ctx, True)
