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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

KERNEL = build.CudaKernel(
    "decode_attention", "decode_attention_launch",
    [build.PTR] * 5 + [build.INT] * 6 + [build.PTR])


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
    o = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  pos.data_ptr(), o.data_ptr(), b, kvh, h // kvh, s, d,
                  build.is_bf16(q), build.stream_ptr(q))
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
