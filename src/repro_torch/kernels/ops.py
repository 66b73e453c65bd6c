"""Front door of the kernels, in the model's layouts.

The signatures are the reference's (src/repro/kernels/ops.py): activations
(B, S, H, D), caches (B, KV, S, D), one pool layer (NB + 1, KV, bs, D); the
recurrences take (B, T, H, N) / (B, T, H, P) and return fp32 outputs and
states.

Dispatch, by `impl`:
  "auto"  (the default) a CUDA tensor launches the hand-written kernel, or
          the kernel's wrapper raises; a CPU tensor takes the plain version.
  "torch" the plain version wherever the tensors are; `chip_smoke.py` uses
          it to hold the kernels against it on the card.
There is no silent fallback: the plain version runs on the card only when
asked for by name.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba2_ssd as _ssd
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import rwkv6_wkv as _wkv

IMPLS = ("auto", "torch")


def _plain(impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}: {impl!r}")
    return impl == "torch"


def flash_attention(q, k, v, causal: bool = True, impl: str = "auto"):
    """q: (B, S, H, D), k/v: (B, S, KV, D) -> (B, S, H, D)."""
    if _plain(impl):
        return _flash.flash_attention_plain(q, k, v, causal)
    return _flash.flash_attention(q, k, v, causal)


def decode_attention(q, k_cache, v_cache, pos, impl: str = "auto"):
    """q: (B, 1, H, D), caches: (B, KV, S, D), pos: (B,) -> (B, 1, H, D)."""
    pos = pos.to(torch.int32)
    if _plain(impl):
        return _dec.decode_attention_plain(q, k_cache, v_cache, pos)
    return _dec.decode_attention(q, k_cache, v_cache, pos)


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, k_new, v_new,
                           max_len: int, impl: str = "auto"):
    """One decode step straight off the paged pool (gather-free).

    q: (B, 1, H, D); k_pages/v_pages: (NBp, KV, bs, D) - ONE layer of
    `PagedKVPool.k/v`; tables: (B, NB) int32 dump-padded block tables;
    lengths: (B,) cached tokens per sequence; k_new/v_new: (B, 1, KV, D)
    the step's own K/V (post-RoPE, not yet in the pool); max_len: batch-max
    sequence length INCLUDING the new token -> (B, 1, H, D)."""
    lengths = lengths.to(torch.int32)
    if _plain(impl):
        return _paged.paged_decode_attention_plain(
            q, k_pages, v_pages, tables, lengths, k_new, v_new, max_len)
    return _paged.paged_decode_attention(
        q, k_pages, v_pages, tables, lengths, k_new, v_new, max_len)


def paged_prefill_attention(q, k_pages, v_pages, table, ctx: int,
                            k_self, v_self, impl: str = "auto"):
    """One prefill chunk of ONE sequence vs its paged context + itself.

    q: (1, C, H, D); k_pages/v_pages: (NBp, KV, bs, D) - one pool layer;
    table: (NB,) int32 block table covering the `ctx` cached tokens
    (dump-padded; may be empty when ctx == 0); ctx: cached token count;
    k_self/v_self: (1, C, KV, D) the chunk's own K/V (post-RoPE)
    -> (1, C, H, D)."""
    if table.shape[0] == 0:
        table = torch.full((1,), k_pages.shape[0] - 1, dtype=torch.int32,
                           device=k_pages.device)             # the dump page
    if _plain(impl):
        return _paged.paged_prefill_attention_plain(
            q, k_pages, v_pages, table, ctx, k_self, v_self)
    return _paged.paged_prefill_attention(
        q, k_pages, v_pages, table, ctx, k_self, v_self)


def rwkv6_wkv(r, k, v, logw, u, state0=None, impl: str = "auto"):
    """RWKV6 WKV over T tokens. r/k/v: (B, T, H, N); logw: (B, T, H, N) <= 0;
    u: (H, N); state0: (B, H, N, N) fp32 or None (zeros)
    -> (y (B, T, H, N) fp32, final state (B, H, N, N) fp32)."""
    logw, u = logw.float(), u.float()
    if _plain(impl):
        return _wkv.wkv_chunked_plain(r, k, v, logw, u, state0)
    return _wkv.rwkv6_wkv(r, k, v, logw, u, state0)


def mamba2_ssd(xh, b_in, c_in, dt, a_log, state0=None, impl: str = "auto"):
    """Mamba2 SSD over T tokens. xh: (B, T, H, P); b_in/c_in: (B, T, N)
    shared across heads; dt: (B, T, H) post-softplus; a_log: (H,); state0:
    (B, H, N, P) fp32 or None (zeros)
    -> (y (B, T, H, P) fp32, final state (B, H, N, P) fp32)."""
    dt, a_log = dt.float(), a_log.float()
    if _plain(impl):
        return _ssd.ssd_plain(xh, b_in, c_in, dt, a_log, state0)
    return _ssd.mamba2_ssd(xh, b_in, c_in, dt, a_log, state0)
