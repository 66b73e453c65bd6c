"""Causal GQA flash attention for the whole-prompt prefill.

`flash_attention` launches the CUDA kernel `csrc/flash_attention.cu` for a
tensor on the card and takes the plain PyTorch version for a tensor on the
CPU. The kernel replaces the TPU kernel `flash_attention_hsd` of
src/repro/kernels/flash_attention.py; it works in the model's (B, S, H, D)
layout, so no transposes surround it, and takes any S.

`attend_block` is the plain version: the reference's dense prefill math
(models/attention.py `_attend_block`), scores in the input dtype, softmax in
fp32, probabilities cast back before the value product.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

KERNEL = build.CudaKernel(
    "flash_attention", "flash_attention_launch",
    [build.PTR] * 4 + [build.INT] * 7 + [build.PTR])


def flash_attention(q, k, v, causal: bool = True):
    """q: (B, S, H, D), k/v: (B, S, KV, D) -> (B, S, H, D)."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal)
    return flash_attention_plain(q, k, v, causal)


def flash_attention_cuda(q, k, v, causal: bool = True):
    """The hand-written kernel; raises on anything it does not take."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    build.check_float("q", q)
    build.check_head_dim(d)
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    build.check("q", q, (b, s, h, d), q.dtype, q.device)
    build.check("k", k, (b, s, kvh, d), q.dtype, q.device)
    build.check("v", v, (b, s, kvh, d), q.dtype, q.device)
    o = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  b, s, h, kvh, d, int(causal), build.is_bf16(q),
                  build.stream_ptr(q))
    return o


def attend_block(q, k, v, q_offset: int, causal: bool):
    """q: (B, Sq, H, D) at global positions q_offset.., k/v: (B, Sk, KV, D)
    -> (B, Sq, H, D); the reference's `_attend_block`, op for op."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    scores = torch.einsum("bsqgd,btqd->bqgst", qg, k) * (d ** -0.5)
    scores = scores.float()
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bqgst,btqd->bsqgd", probs, v)
    return o.reshape(b, sq, h, d)


def flash_attention_plain(q, k, v, causal: bool = True, q_block: int = 1024):
    """The plain version: `attend_block` over query blocks of `q_block`
    rows, the reference's non-kernel `multihead_attention`."""
    s = q.shape[1]
    if s <= q_block:
        return attend_block(q, k, v, 0, causal)
    outs = []
    for i in range(0, s, q_block):
        hi = min(i + q_block, s)
        kend = hi if causal else s
        outs.append(attend_block(q[:, i:hi], k[:, :kend], v[:, :kend], i, causal))
    return torch.cat(outs, dim=1)
