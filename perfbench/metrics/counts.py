"""Operations and bytes the served models need, from their shapes, and the
card's peaks they are held against.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): 989e12
bf16 FLOP/s on the tensor cores, 3.35e12 bytes/s of HBM3. A roofline bound
is max(FLOPs / peak FLOP/s, bytes / peak bytes/s), each input byte read
once and each output byte written once.
"""
from __future__ import annotations

import math

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2
INT32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _attn(cfg: dict):
    return cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]


def paged_decode_call(ctxs, cfg: dict) -> tuple[float, float]:
    """One layer's paged decode kernel over a batch whose sequences hold
    `ctxs` cached tokens each (plus the step's own token): FLOPs, bytes."""
    h, kv, dh = _attn(cfg)
    bs = cfg["engine"]["block_size"]
    keys = sum(c + 1 for c in ctxs)
    flops = 4 * h * dh * keys                                   # q k^T and p v
    nbytes = (BF16 * 2 * kv * dh * keys                         # K and V, cached and new
              + BF16 * 2 * h * dh * len(ctxs)                   # q in, o out
              + INT32 * (len(ctxs) + sum(math.ceil(c / bs) for c in ctxs)))  # lengths, pages
    return flops, nbytes


def paged_prefill_call(ctx0: int, t: int, cfg: dict) -> tuple[float, float]:
    """One layer's paged prefill kernel on a chunk of t tokens after ctx0
    cached ones, causal: FLOPs, bytes."""
    h, kv, dh = _attn(cfg)
    bs = cfg["engine"]["block_size"]
    pairs = t * ctx0 + t * (t + 1) / 2
    flops = 4 * h * dh * pairs
    nbytes = (BF16 * 2 * kv * dh * (ctx0 + t) + BF16 * 2 * h * dh * t
              + INT32 * math.ceil(ctx0 / bs))
    return flops, nbytes


def matmul_params(cfg: dict) -> int:
    """Weights a token goes through in the layers' products: for moe the
    router, its top-k experts and the shared expert, not the padded slots."""
    h, kv, dh = _attn(cfg)
    d = cfg["hidden_size"]
    attn = d * (h + 2 * kv) * dh + h * dh * d
    if cfg["family"] == "moe":
        ffn = (d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d
               * cfg["moe_intermediate_size"] + 3 * d * cfg["shared_expert_intermediate_size"])
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + ffn)


def step_flops(obs, cfg: dict) -> float:
    """Model FLOPs of one engine step: 2 x weights x tokens through the
    layers, the lm_head on each row it scores (one a decode, one a chunk),
    and causal attention. A prompt token counts once, however the program
    computes it."""
    h, _, dh = _attn(cfg)
    tokens = len(obs.decode_ctx) + sum(t for _, t in obs.chunks)
    rows = len(obs.decode_ctx) + len(obs.chunks)
    attn = (sum(4 * h * dh * (c + 1) for c in obs.decode_ctx)
            + sum(4 * h * dh * (t * c + t * (t + 1) / 2) for c, t in obs.chunks))
    return (2 * matmul_params(cfg) * tokens + 2 * cfg["hidden_size"] * cfg["vocab_size"] * rows
            + cfg["num_hidden_layers"] * attn)
