"""Attention of the dense family: whole-prompt prefill, single-token decode
over a dense cache, K-token extension (speculative verify), and the two
paged steps that read the KV pool in place.

With `exec_cfg.use_kernels` (the port's default) prefill and decode go
through `kernels/ops.py`: the hand-written kernels on the card, their plain
versions on the CPU. Without it they run the reference's own math
(src/repro/models/attention.py), which the port keeps for the CPU only.
The projections stay `@` products, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.decode_attention import NEG_INF, decode_attention_plain
from repro_torch.kernels.flash_attention import attend_block, flash_attention_plain
from repro_torch.models.config import AttentionConfig, ModelConfig
from repro_torch.models.layers import (
    DEFAULT_EXEC,
    ExecConfig,
    apply_rope,
    normal,
    plain_only,
    rope_angles,
    torch_dtype,
)


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    a = cfg.attn
    d = cfg.d_model
    dtype = torch_dtype(cfg)
    return {
        "wq": normal(gen, (d, a.q_dim), d ** -0.5, dtype),
        "wk": normal(gen, (d, a.kv_dim), d ** -0.5, dtype),
        "wv": normal(gen, (d, a.kv_dim), d ** -0.5, dtype),
        "wo": normal(gen, (a.q_dim, d), a.q_dim ** -0.5, dtype),
    }


# the reference's `_attend_block` (q: (B, qb, H, D) at offset q_offset)
_attend_block = attend_block


def multihead_attention(q, k, v, cfg_attn: AttentionConfig,
                        exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Full-sequence causal attention. q: (B, S, H, D) (already RoPE'd),
    k/v: (B, S, KV, D) -> (B, S, H, D)."""
    if exec_cfg.use_kernels:
        return kops.flash_attention(q, k, v, causal=cfg_attn.causal,
                                    impl=exec_cfg.impl)
    plain_only(q, "multihead_attention")
    return flash_attention_plain(q, k, v, cfg_attn.causal, exec_cfg.q_block)


def decode_attention(q, k_cache, v_cache, pos,
                     exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Single-token attention against a (padded) KV cache. q: (B, 1, H, D),
    caches (B, KV, S_max, D), pos: (B,) current lengths (q is at pos)."""
    if exec_cfg.use_kernels:
        return kops.decode_attention(q, k_cache, v_cache, pos, impl=exec_cfg.impl)
    plain_only(q, "decode_attention")
    return decode_attention_plain(q, k_cache, v_cache, pos)


def _qkv(p: dict, x, a: AttentionConfig):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, a.num_heads, a.head_dim)
    k = (x @ p["wk"]).reshape(b, s, a.num_kv_heads, a.head_dim)
    v = (x @ p["wv"]).reshape(b, s, a.num_kv_heads, a.head_dim)
    return q, k, v


def _rope(q, k, positions, a: AttentionConfig):
    if a.m_rope_sections is not None:
        raise NotImplementedError(
            "M-RoPE (vlm family) is not ported yet: ROADMAP queue 1, item 9")
    sin, cos = rope_angles(positions, a.head_dim, a.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos)


def _write_at(cache, new, pos):
    """cache (B, KV, S, D) <- new (B, KV, K, D) at per-sequence slots
    pos[b] .. pos[b] + K - 1, in place."""
    b, _, kk, _ = new.shape
    rows = torch.arange(b, device=cache.device)[:, None]
    slots = pos.long()[:, None] + torch.arange(kk, device=cache.device)[None, :]
    cache[rows, :, slots] = new.permute(0, 2, 1, 3)


def attention_block(p: dict, x, positions, cfg: ModelConfig,
                    exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Projections + RoPE + causal attention over x (B, S, D_model). Returns
    (out, (k, v)) with k/v (B, S, KV, D) for the caller's KV cache."""
    a = cfg.attn
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, a)
    q, k = _rope(q, k, positions, a)
    o = multihead_attention(q, k, v, a, exec_cfg)
    return o.reshape(b, s, -1) @ p["wo"], (k, v)


def attention_extend_block(p: dict, x, k_cache, v_cache, pos, cfg: ModelConfig,
                           exec_cfg: ExecConfig = DEFAULT_EXEC):
    """K new tokens x (B, K, D_model) at positions pos.. attend over the
    prefix plus themselves; their K/V are written into the caches in place.
    Used by speculative verification. Returns (out, k_cache, v_cache)."""
    a = cfg.attn
    b, kk, _ = x.shape
    q, k, v = _qkv(p, x, a)
    prope = pos.long()[:, None] + torch.arange(kk, device=x.device)[None, :]
    q, k = _rope(q, k, prope, a)
    _write_at(k_cache, k.transpose(1, 2), pos)
    _write_at(v_cache, v.transpose(1, 2), pos)

    kvh, smax = k_cache.shape[1], k_cache.shape[2]
    g = a.num_heads // kvh
    qh = q.reshape(b, kk, kvh, g, a.head_dim)
    scores = torch.einsum("bsqgd,bqtd->bqgst", qh, k_cache).float() * (a.head_dim ** -0.5)
    mask = torch.arange(smax, device=x.device)[None, None, :] <= prope[:, :, None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bqgst,bqtd->bsqgd", probs, v_cache).reshape(b, kk, -1)
    return o @ p["wo"], k_cache, v_cache


def attention_decode_block(p: dict, x, k_cache, v_cache, pos, positions_rope,
                           cfg: ModelConfig, exec_cfg: ExecConfig = DEFAULT_EXEC):
    """One decode step of x (B, 1, D_model): write the new K/V at `pos` in
    the caches (in place), attend over the prefix. Returns (out, k, v)."""
    a = cfg.attn
    b = x.shape[0]
    q, k, v = _qkv(p, x, a)
    q, k = _rope(q, k, positions_rope, a)
    _write_at(k_cache, k.transpose(1, 2), pos)
    _write_at(v_cache, v.transpose(1, 2), pos)
    o = decode_attention(q, k_cache, v_cache, pos, exec_cfg)
    return o.reshape(b, 1, -1) @ p["wo"], k_cache, v_cache


def attention_paged_decode_block(p: dict, x, k_pages, v_pages, tables, lengths,
                                 positions_rope, cfg: ModelConfig,
                                 exec_cfg: ExecConfig = DEFAULT_EXEC,
                                 max_len: int = 0):
    """Gather-free decode step against one pool layer: the pages and block
    tables go straight to `kops.paged_decode_attention`; the step's own
    (k, v) (B, 1, KV, D) come back for the caller's `scatter_append`."""
    a = cfg.attn
    b = x.shape[0]
    q, k, v = _qkv(p, x, a)
    q, k = _rope(q, k, positions_rope, a)
    o = kops.paged_decode_attention(q, k_pages, v_pages, tables, lengths, k, v,
                                    max_len=max_len, impl=exec_cfg.impl)
    return o.reshape(b, 1, -1) @ p["wo"], k, v


def attention_paged_chunk_block(p: dict, x, k_pages, v_pages, table, ctx0: int,
                                cfg: ModelConfig,
                                exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Fused chunked prefill: C new tokens x (1, C, D_model) of one sequence
    attend over its paged cached context (ctx0 tokens) plus themselves.
    Returns (out, k, v) with k/v (1, C, KV, D) for `scatter_chunk`."""
    a = cfg.attn
    _, c, _ = x.shape
    q, k, v = _qkv(p, x, a)
    positions = ctx0 + torch.arange(c, device=x.device)[None, :]
    q, k = _rope(q, k, positions, a)
    o = kops.paged_prefill_attention(q, k_pages, v_pages, table, ctx0, k, v,
                                     impl=exec_cfg.impl)
    return o.reshape(1, c, -1) @ p["wo"], k, v
