"""Decoder backbone of the dense family (pre-norm GQA transformer, RoPE,
SwiGLU): the serving entry points of src/repro/models/backbone.py.

    init_params(gen, cfg)                               -> params
    prefill(params, batch, cfg, exec_cfg)               -> (last_logits, cache)
    serve_step(params, cache, tokens, cfg, exec_cfg)    -> (logits, cache)
    serve_step_paged(params, pages_k, pages_v, ...)     -> (logits, k_tok, v_tok)
    prefill_chunk_paged(params, pages_k, pages_v, ...)  -> (logits, k_c, v_c)
    extend_step(params, cache, tokens, cfg, exec_cfg)   -> (logits, cache)

Params are a dict: {"tok": {"embed", "lm_head"?}, "layers": [one dict per
layer], "final_norm"}. The reference stacks the layers along a leading axis
and runs `lax.scan`; here a Python loop walks the list, and the paged steps
read pool layer l as the view `pages_k[l]`, never a copy. A dense cache is
{"k", "v": (L, B, KV, S, D), "pos": (B,) int32}; serve_step and extend_step
write the new K/V into it in place and return it with `pos` advanced.

Other families (moe, ssm, hybrid, audio, vlm) are not ported yet and raise
NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import (
    attention_block,
    attention_decode_block,
    attention_extend_block,
    attention_paged_chunk_block,
    attention_paged_decode_block,
    init_attention,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    DEFAULT_EXEC,
    ExecConfig,
    embed_tokens,
    init_embed,
    init_rmsnorm,
    init_swiglu,
    lm_logits,
    rmsnorm,
    swiglu,
    torch_dtype,
)

Params = dict
Cache = dict


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP "
            "queue 1, item 9 (other families)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random dense weights drawn from `gen`, on the generator's device."""
    _dense_only(cfg)
    d, dtype, dev = cfg.d_model, torch_dtype(cfg), gen.device
    tok = init_embed(gen, cfg)
    layers = [{"norm1": init_rmsnorm(d, dev), "norm2": init_rmsnorm(d, dev),
               "attn": init_attention(gen, cfg),
               "ffn": init_swiglu(gen, d, cfg.d_ff, dtype)}
              for _ in range(cfg.num_layers)]
    return {"tok": tok, "layers": layers, "final_norm": init_rmsnorm(d, dev)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _ffn(lp: dict, x, cfg: ModelConfig):
    return x + swiglu(lp["ffn"], rmsnorm(lp["norm2"], x, cfg.norm_eps))


def _final_logits(params: Params, x, cfg: ModelConfig):
    return lm_logits(params["tok"], rmsnorm(params["final_norm"], x, cfg.norm_eps))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def prefill(params: Params, batch: dict, cfg: ModelConfig,
            exec_cfg: ExecConfig = DEFAULT_EXEC) -> tuple[torch.Tensor, Cache]:
    """Prompt processing of batch {"tokens": (B, S)}: (logits at the last
    position (B, V), cache with k/v (L, B, KV, S, D))."""
    _dense_only(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params["tok"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    ks, vs = [], []
    for lp in params["layers"]:
        h, (k, v) = attention_block(lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps),
                                    positions, cfg, exec_cfg)
        x = _ffn(lp, x + h, cfg)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    logits = _final_logits(params, x[:, -1:], cfg)[:, 0]
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pos}


def serve_step(params: Params, cache: Cache, tokens, cfg: ModelConfig,
               exec_cfg: ExecConfig = DEFAULT_EXEC) -> tuple[torch.Tensor, Cache]:
    """One decode step for a batch: tokens (B,) -> (logits (B, V), cache with
    the new K/V written at `pos` and `pos` advanced by 1)."""
    _dense_only(cfg)
    pos = cache["pos"]
    x = embed_tokens(params["tok"], tokens)[:, None, :]            # (B, 1, D)
    prope = pos[:, None]
    for l, lp in enumerate(params["layers"]):
        h, _, _ = attention_decode_block(
            lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps), cache["k"][l],
            cache["v"][l], pos, prope, cfg, exec_cfg)
        x = _ffn(lp, x + h, cfg)
    logits = _final_logits(params, x, cfg)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def serve_step_paged(params: Params, pages_k, pages_v, tables, lengths, tokens,
                     cfg: ModelConfig, exec_cfg: ExecConfig = DEFAULT_EXEC,
                     max_len: int = 0):
    """One gather-free decode step straight off PagedKVPool storage.

    pages_k/pages_v: (L, NBp, KV, bs, D) - the pool's page arrays; tables:
    (B, NB) int32 dump-padded block tables; lengths: (B,) cached tokens per
    sequence; tokens: (B,); max_len: batch-max length including the new
    token. Returns (logits (B, V), k_tok (L, B, KV, D), v_tok) - the step's
    own K/V for `scatter_append`."""
    _dense_only(cfg)
    x = embed_tokens(params["tok"], tokens)[:, None, :]            # (B, 1, D)
    prope = lengths[:, None]
    kts, vts = [], []
    for l, lp in enumerate(params["layers"]):
        h, kt, vt = attention_paged_decode_block(
            lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps), pages_k[l],
            pages_v[l], tables, lengths, prope, cfg, exec_cfg, max_len=max_len)
        x = _ffn(lp, x + h, cfg)
        kts.append(kt[:, 0])
        vts.append(vt[:, 0])
    logits = _final_logits(params, x, cfg)[:, 0]
    return logits, torch.stack(kts), torch.stack(vts)


def prefill_chunk_paged(params: Params, pages_k, pages_v, table, ctx0: int,
                        tokens, cfg: ModelConfig,
                        exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Incremental chunked prefill of ONE sequence: tokens (C,) at positions
    [ctx0, ctx0 + C) attend over its ctx0 cached tokens (through `table`
    (NB,)) plus themselves. Returns (last_logits (1, V), k_c (L, KV, C, D),
    v_c) for `scatter_chunk`."""
    _dense_only(cfg)
    x = embed_tokens(params["tok"], tokens[None, :])               # (1, C, D)
    kcs, vcs = [], []
    for l, lp in enumerate(params["layers"]):
        h, kt, vt = attention_paged_chunk_block(
            lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps), pages_k[l],
            pages_v[l], table, ctx0, cfg, exec_cfg)
        x = _ffn(lp, x + h, cfg)
        kcs.append(kt[0].transpose(0, 1))
        vcs.append(vt[0].transpose(0, 1))
    logits = _final_logits(params, x[:, -1:], cfg)[:, 0]
    return logits, torch.stack(kcs), torch.stack(vcs)


def extend_step(params: Params, cache: Cache, tokens, cfg: ModelConfig,
                exec_cfg: ExecConfig = DEFAULT_EXEC) -> tuple[torch.Tensor, Cache]:
    """K new tokens (B, K) against an existing cache (speculative verify):
    (logits (B, K, V), cache with their K/V written and `pos` advanced by K)."""
    _dense_only(cfg)
    pos = cache["pos"]
    x = embed_tokens(params["tok"], tokens)
    for l, lp in enumerate(params["layers"]):
        h, _, _ = attention_extend_block(
            lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps), cache["k"][l],
            cache["v"][l], pos, cfg, exec_cfg)
        x = _ffn(lp, x + h, cfg)
    logits = _final_logits(params, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + tokens.shape[1]}
