"""Decoder backbone: the entry points of src/repro/models/backbone.py for
all six families: dense (pre-norm GQA
transformer, RoPE, SwiGLU), moe (the same with a routed mixture of experts
in place of the SwiGLU), audio and vlm (the dense stack fed frame or patch
embeddings, vlm with M-RoPE), ssm (RWKV6) and hybrid (Mamba2 layers with one
shared attention block applied every `hybrid_attn_every` layers).

    init_params(gen, cfg)                               -> params
    forward(params, batch, cfg, exec_cfg)               -> logits (B, S, V)
    loss_fn(params, batch, cfg, exec_cfg)               -> mean next-token CE
    init_cache(cfg, batch, max_seq, dtype, device)      -> cache
    prefill(params, batch, cfg, exec_cfg)               -> (last_logits, cache)
    serve_step(params, cache, tokens, cfg, exec_cfg, embeds=None)
                                                        -> (logits, cache)
    extend_step(params, cache, tokens, cfg, exec_cfg)   -> (logits, cache)
    serve_step_paged(params, pages_k, pages_v, ...)     -> (logits, k_tok, v_tok)
    prefill_chunk_paged(params, pages_k, pages_v, ...)  -> (logits, k_c, v_c)

`batch` is {"tokens": (B, S)} or, for the stubbed frontends (audio
frames, vision patches), {"embeds": (B, S, D)}; M-RoPE takes
{"positions": (3, B, S)} (three equal streams if absent); loss_fn adds
{"labels": (B, S)}.

forward and loss_fn are the training path: with the reference's training
config (layers.TRAIN_EXEC: the blocked attention and the chunked scans, each
layer, or each tap group of the hybrid, recomputed in the backward pass)
they run on either device and reach no kernel. The serving entry points
take use_kernels=False on the CPU only (layers.serving_guard). As in the
reference, serve_step_paged takes the dense and moe families and
prefill_chunk_paged the dense family only: MoE routes per group of tokens,
so a chunk alone would route otherwise than the whole prefix does.

Params are a dict: {"tok": {"embed", "lm_head"?}, "layers": [one dict per
layer], "final_norm"} plus, for the hybrid, "shared_attn": {"attn",
"norm"}. The reference stacks the layers along a leading axis and runs
`lax.scan`; here a Python loop walks the list, and the paged steps read pool
layer l as the view `pages_k[l]`, never a copy. Caches, as the reference's:

    dense, moe, audio, vlm
            {"k", "v": (L, B, KV, S, D), "pos": (B,) int32}
    ssm     {"state": (L, B, H, N, N) fp32, "x_prev_att", "x_prev_ffn":
             (L, B, D), "pos"}
    hybrid  {"ssm_state": (L, B, H, N, P) fp32, "conv_state":
             (L, B, W - 1, C), "k", "v": (taps, B, KV, S, D), "pos"}

serve_step and extend_step write new K/V into the given cache in place and
return a cache with the recurrent states replaced and `pos` advanced.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.distributed.tensor_parallel import vocab_parallel_cross_entropy
from repro_torch.models import mamba2, rwkv6
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
    constrain_carry,
    embed_tokens,
    init_embed,
    init_moe,
    init_rmsnorm,
    init_swiglu,
    lm_logits,
    moe_aux_loss,
    moe_ffn,
    rmsnorm,
    serving_guard,
    swiglu,
    torch_dtype,
)

Params = dict
Cache = dict


PORTED = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
# the families whose every layer is attention + FFN over a dense K/V cache
ATTENTION = ("dense", "moe", "audio", "vlm")


def _check_family(cfg: ModelConfig, families: tuple = PORTED) -> None:
    if cfg.family not in families:
        raise ValueError(f"family {cfg.family!r} ({cfg.name}): this entry point "
                         f"takes {families} only, as in the reference")


def _serving(params: Params, cfg: ModelConfig, exec_cfg: ExecConfig, what: str,
             families: tuple = PORTED) -> None:
    _check_family(cfg, families)
    serving_guard(params["final_norm"], exec_cfg, what)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dtype, dev = cfg.d_model, torch_dtype(cfg), gen.device
    p = {"norm1": init_rmsnorm(d, dev), "norm2": init_rmsnorm(d, dev)}
    if cfg.family == "moe":
        p["attn"] = init_attention(gen, cfg)
        p["moe"] = init_moe(gen, cfg)
    elif cfg.family in ATTENTION:
        p["attn"] = init_attention(gen, cfg)
        p["ffn"] = init_swiglu(gen, d, cfg.d_ff, dtype)
    elif cfg.family == "ssm":
        p["time_mix"] = rwkv6.init_time_mix(gen, cfg)
        p["channel_mix"] = rwkv6.init_channel_mix(gen, cfg)
    else:
        p["mamba"] = mamba2.init_mamba2(gen, cfg)
        p["ffn"] = init_swiglu(gen, d, cfg.d_ff, dtype)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights drawn from `gen`, on the generator's device."""
    _check_family(cfg)
    d, dev = cfg.d_model, gen.device
    params = {"tok": init_embed(gen, cfg),
              "layers": [_init_layer(gen, cfg) for _ in range(cfg.num_layers)],
              "final_norm": init_rmsnorm(d, dev)}
    if cfg.family == "hybrid":
        params["shared_attn"] = {"attn": init_attention(gen, cfg),
                                 "norm": init_rmsnorm(d, dev)}
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Cache:
    """An empty cache for `batch` sequences of up to `max_seq` tokens, on
    `device` (the card unless the caller names the CPU)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    L = cfg.num_layers

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    c: Cache = {"pos": zeros(batch, dt=torch.int32)}
    if cfg.family == "ssm":
        n = cfg.rwkv.head_dim
        c["state"] = zeros(L, batch, cfg.d_model // n, n, n, dt=torch.float32)
        c["x_prev_att"] = zeros(L, batch, cfg.d_model)
        c["x_prev_ffn"] = zeros(L, batch, cfg.d_model)
        return c
    a = cfg.attn
    kv_layers = L
    if cfg.family == "hybrid":
        s = cfg.ssm
        _, nheads, conv_ch = mamba2.dims(cfg)
        c["ssm_state"] = zeros(L, batch, nheads, s.state_dim, s.head_dim, dt=torch.float32)
        c["conv_state"] = zeros(L, batch, s.conv_width - 1, conv_ch)
        kv_layers = L // cfg.hybrid_attn_every
    c["k"] = zeros(kv_layers, batch, a.num_kv_heads, max_seq, a.head_dim)
    c["v"] = torch.zeros_like(c["k"])
    return c


def _grow_cache(cache: Cache, cfg: ModelConfig, max_seq: int) -> Cache:
    """Pad a prefill's K/V out to `max_seq` slots for decoding (a recurrent
    cache without K/V is returned as it is)."""
    if "k" not in cache or cache["k"].shape[3] >= max_seq:
        return cache
    pad = (0, 0, 0, max_seq - cache["k"].shape[3])
    return {**cache, "k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _residual(x, h, exec_cfg: ExecConfig):
    """x + h on the residual stream. Under a carry_spec (a sharded step)
    both are first placed as the carry (`constrain_carry`): h, a
    row-parallel product's partial sum over "model", is reduce-scattered
    onto the sequence shards, rather than left to DTensor, which may gather
    weights instead. The last add of each layer so leaves its output
    placed where the reference's layer ends constrain it."""
    return constrain_carry(x, exec_cfg) + constrain_carry(h, exec_cfg)


def _ffn(lp: dict, x, cfg: ModelConfig, exec_cfg: ExecConfig):
    """The residual FFN of a layer: the routed experts for moe, else
    SwiGLU. It ends the attention and Mamba2 layers. Span: `model.moe` or
    `model.ffn`."""
    moe = cfg.family == "moe"
    with tracing.span("model.moe" if moe else "model.ffn"):
        xn = rmsnorm(lp["norm2"], x, cfg.norm_eps)
        h = moe_ffn(lp["moe"], xn, cfg, exec_cfg) if moe else swiglu(lp["ffn"], xn)
        return _residual(x, h, exec_cfg)


def _final_logits(params: Params, x, cfg: ModelConfig):
    return lm_logits(params["tok"], rmsnorm(params["final_norm"], x, cfg.norm_eps))


def _rwkv_layer(lp: dict, x, cfg: ModelConfig, exec_cfg: ExecConfig,
                x_prev_att=None, x_prev_ffn=None, state0=None):
    """One RWKV6 layer over a segment x (B, T, D), from the carried token
    shifts and state (zeros if None). Returns (x, (last_att, last_ffn,
    state))."""
    zp = torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype, device=x.device)
    h, (last_att, state) = rwkv6.time_mix(
        lp["time_mix"], rmsnorm(lp["norm1"], x, cfg.norm_eps),
        zp if x_prev_att is None else x_prev_att, state0, cfg, exec_cfg)
    x = _residual(x, h, exec_cfg)
    h, last_ffn = rwkv6.channel_mix(
        lp["channel_mix"], rmsnorm(lp["norm2"], x, cfg.norm_eps),
        zp if x_prev_ffn is None else x_prev_ffn)
    return _residual(x, h, exec_cfg), (last_att, last_ffn, state)


def _mamba_layer(lp: dict, x, cfg: ModelConfig, exec_cfg: ExecConfig,
                 state0=None, conv_prev=None):
    """One Mamba2 layer (mixer, then SwiGLU) over a segment x (B, T, D).
    Returns (x, (ssm_state, conv_state))."""
    h, (state, conv) = mamba2.mamba2_block(
        lp["mamba"], rmsnorm(lp["norm1"], x, cfg.norm_eps), cfg, state0, conv_prev,
        exec_cfg)
    return _ffn(lp, _residual(x, h, exec_cfg), cfg, exec_cfg), (state, conv)


def _is_tap(cfg: ModelConfig, layer: int) -> bool:
    """Whether the hybrid's shared attention block follows this layer."""
    return (layer + 1) % cfg.hybrid_attn_every == 0


def _recurrent_segment(params: Params, cache: Cache | None, x, cfg: ModelConfig,
                       exec_cfg: ExecConfig, positions=None):
    """The ssm or hybrid stack over a segment x (B, T, D): from zeros and
    whole-prompt attention (cache None, prefill, `positions` (B, T)), or from
    `cache` with the shared attention extending its K/V in place
    (extend_step). Returns (x, cache pieces without `pos`)."""
    layers = params["layers"]
    if cfg.family == "ssm":
        sts, las, lfs = [], [], []
        for l, lp in enumerate(layers):
            carry = (None,) * 3 if cache is None else (
                cache["x_prev_att"][l], cache["x_prev_ffn"][l], cache["state"][l])
            x, (la, lf, st) = _rwkv_layer(lp, x, cfg, exec_cfg, *carry)
            sts.append(st)
            las.append(la)
            lfs.append(lf)
        return x, {"state": torch.stack(sts), "x_prev_att": torch.stack(las),
                   "x_prev_ffn": torch.stack(lfs)}
    sp = params["shared_attn"]
    sts, cvs, ks, vs = [], [], [], []
    for l, lp in enumerate(layers):
        carry = (None, None) if cache is None else (
            cache["ssm_state"][l], cache["conv_state"][l])
        x, (st, cv) = _mamba_layer(lp, x, cfg, exec_cfg, *carry)
        sts.append(st)
        cvs.append(cv)
        if not _is_tap(cfg, l):
            continue
        xn = rmsnorm(sp["norm"], x, cfg.norm_eps)
        if cache is None:
            h, (k, v) = attention_block(sp["attn"], xn, positions, cfg, exec_cfg)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        else:
            tap = l // cfg.hybrid_attn_every
            h, _, _ = attention_extend_block(sp["attn"], xn, cache["k"][tap],
                                             cache["v"][tap], cache["pos"], cfg, exec_cfg)
        x = _residual(x, h, exec_cfg)
    pieces = {"ssm_state": torch.stack(sts), "conv_state": torch.stack(cvs)}
    if cache is None:
        pieces.update(k=torch.stack(ks), v=torch.stack(vs))
    else:
        pieces.update(k=cache["k"], v=cache["v"])
    return x, pieces


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def _m_rope(cfg: ModelConfig) -> bool:
    return cfg.attn is not None and cfg.attn.m_rope_sections is not None


def _embed_in(params: Params, batch: dict):
    if "embeds" in batch:
        return batch["embeds"]
    return embed_tokens(params["tok"], batch["tokens"])


def _positions_in(batch: dict, b: int, s: int, cfg: ModelConfig, device):
    """batch["positions"], else 0 .. s - 1 for every sequence (three equal
    streams under M-RoPE)."""
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(s, device=device).expand(b, s)
    return pos.expand(3, b, s) if _m_rope(cfg) else pos


def _train_stages(params: Params, cfg: ModelConfig, exec_cfg: ExecConfig, positions):
    """The stack as a list of functions x -> x, each one checkpoint unit of
    the reference's training forward: a layer, or for the hybrid a tap group
    (hybrid_attn_every Mamba2 layers, then the shared attention)."""
    def attn_layer(lp):
        def run(x):
            h, _ = attention_block(lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps),
                                   positions, cfg, exec_cfg)
            return _ffn(lp, _residual(x, h, exec_cfg), cfg, exec_cfg)
        return run

    def rwkv_layer(lp):
        return lambda x: _rwkv_layer(lp, x, cfg, exec_cfg)[0]

    def tap_group(group):
        sp = params["shared_attn"]

        def run(x):
            for lp in group:
                x, _ = _mamba_layer(lp, x, cfg, exec_cfg)
            h, _ = attention_block(sp["attn"], rmsnorm(sp["norm"], x, cfg.norm_eps),
                                   positions, cfg, exec_cfg)
            return _residual(x, h, exec_cfg)
        return run

    layers = params["layers"]
    if cfg.family in ATTENTION:
        return [attn_layer(lp) for lp in layers]
    if cfg.family == "ssm":
        return [rwkv_layer(lp) for lp in layers]
    every = cfg.hybrid_attn_every
    if len(layers) % every:
        raise ValueError(f"{len(layers)} layers do not group into taps of {every}, "
                         "as the reference's training stack needs")
    return [tap_group(layers[i:i + every]) for i in range(0, len(layers), every)]


def forward(params: Params, batch: dict, cfg: ModelConfig,
            exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Training forward: logits (B, S, V) for every position. With
    exec_cfg.remat each stage (a layer; a tap group for the hybrid) runs
    under a checkpoint, so the backward pass keeps only the stages' inputs
    and recomputes the rest, as the reference's `jax.checkpoint` does."""
    _check_family(cfg)
    x = _embed_in(params, batch)
    b, s, _ = x.shape
    positions = _positions_in(batch, b, s, cfg, x.device)
    remat = exec_cfg.remat and torch.is_grad_enabled()
    for stage in _train_stages(params, cfg, exec_cfg, positions):
        x = checkpoint(stage, x, use_reentrant=False) if remat else stage(x)
    return _final_logits(params, x, cfg)


def cross_entropy(logits, labels, vocab_size: int):
    """Mean next-token cross-entropy in fp32, the gold logit taken by a
    one-hot masked sum (as the reference, whose vocab dim is sharded); a
    logits tensor sharded over the vocab (the sharded train step) takes the
    hand-written vocab-parallel form of distributed/tensor_parallel.py."""
    if isinstance(logits, DTensor):
        return vocab_parallel_cross_entropy(logits, labels)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    onehot = labels[..., None] == torch.arange(vocab_size, device=labels.device)
    gold = torch.where(onehot, lf, 0.0).sum(dim=-1)
    return (lse - gold).mean()


def loss_fn(params: Params, batch: dict, cfg: ModelConfig,
            exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Mean next-token cross-entropy against batch["labels"], plus for moe
    0.01 times layer 0's load-balancing loss on the embeddings."""
    ce = cross_entropy(forward(params, batch, cfg, exec_cfg), batch["labels"], cfg.vocab_size)
    if cfg.family == "moe":
        aux = moe_aux_loss(params["layers"][0]["moe"], _embed_in(params, batch), cfg, exec_cfg)
        ce = ce + 0.01 * aux
    return ce


def prefill(params: Params, batch: dict, cfg: ModelConfig,
            exec_cfg: ExecConfig = DEFAULT_EXEC) -> tuple[torch.Tensor, Cache]:
    """Prompt processing of batch {"tokens": (B, S)} or {"embeds": (B, S, D)}
    (plus {"positions": (3, B, S)} under M-RoPE): (logits at the last
    position (B, V), cache; the K/V of the attention families and the hybrid
    hold exactly S slots). Spans: `model.forward`, a `model.attn` a layer."""
    _serving(params, cfg, exec_cfg, "prefill")
    with tracing.span("model.forward"):
        x = _embed_in(params, batch)
        b, s, _ = x.shape
        positions = _positions_in(batch, b, s, cfg, x.device)
        pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
        if cfg.family not in ATTENTION:
            x, cache = _recurrent_segment(params, None, x, cfg, exec_cfg, positions)
            return _final_logits(params, x[:, -1:], cfg)[:, 0], {**cache, "pos": pos}
        ks, vs = [], []
        for lp in params["layers"]:
            with tracing.span("model.attn"):
                h, (k, v) = attention_block(lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps),
                                            positions, cfg, exec_cfg)
            x = _ffn(lp, _residual(x, h, exec_cfg), cfg, exec_cfg)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        logits = _final_logits(params, x[:, -1:], cfg)[:, 0]
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pos}


def serve_step(params: Params, cache: Cache, tokens, cfg: ModelConfig,
               exec_cfg: ExecConfig = DEFAULT_EXEC,
               embeds=None) -> tuple[torch.Tensor, Cache]:
    """One decode step for a batch: tokens (B,), or `embeds` (B, D) in their
    place (the audio frontend) -> (logits (B, V), cache with the new K/V
    written at `pos`, the recurrent states stepped, and `pos` advanced by
    1). Under M-RoPE the three streams are all `pos`, as in the
    reference."""
    _serving(params, cfg, exec_cfg, "serve_step")
    pos = cache["pos"]
    x = embeds if embeds is not None else embed_tokens(params["tok"], tokens)
    x = x[:, None, :]                                              # (B, 1, D)
    prope = pos[:, None]
    if _m_rope(cfg):
        prope = prope.expand(3, *prope.shape)
    if cfg.family == "ssm":
        return _rwkv_step(params, cache, x[:, 0], cfg)
    if cfg.family == "hybrid":
        return _hybrid_step(params, cache, x[:, 0], prope, cfg, exec_cfg)
    for l, lp in enumerate(params["layers"]):
        h, _, _ = attention_decode_block(
            lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps), cache["k"][l],
            cache["v"][l], pos, prope, cfg, exec_cfg)
        x = _ffn(lp, x + h, cfg, exec_cfg)
    logits = _final_logits(params, x, cfg)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def _rwkv_step(params: Params, cache: Cache, x, cfg: ModelConfig):
    """serve_step of the ssm family; x: (B, D) embedded tokens."""
    sts, las, lfs = [], [], []
    for l, lp in enumerate(params["layers"]):
        h, la, st = rwkv6.time_mix_step(
            lp["time_mix"], rmsnorm(lp["norm1"], x, cfg.norm_eps),
            cache["x_prev_att"][l], cache["state"][l], cfg)
        x = x + h
        h, lf = rwkv6.channel_mix_step(
            lp["channel_mix"], rmsnorm(lp["norm2"], x, cfg.norm_eps), cache["x_prev_ffn"][l])
        x = x + h
        sts.append(st)
        las.append(la)
        lfs.append(lf)
    logits = _final_logits(params, x, cfg)
    return logits, {"state": torch.stack(sts), "x_prev_att": torch.stack(las),
                    "x_prev_ffn": torch.stack(lfs), "pos": cache["pos"] + 1}


def _hybrid_step(params: Params, cache: Cache, x, prope, cfg: ModelConfig,
                 exec_cfg: ExecConfig):
    """serve_step of the hybrid family; x: (B, D) embedded tokens. The shared
    attention block writes its K/V into tap l // every of the cache."""
    pos, sp = cache["pos"], params["shared_attn"]
    sts, cvs = [], []
    for l, lp in enumerate(params["layers"]):
        h, (st, cv) = mamba2.mamba2_step(
            lp["mamba"], rmsnorm(lp["norm1"], x, cfg.norm_eps), cache["ssm_state"][l],
            cache["conv_state"][l], cfg)
        x = _ffn(lp, x + h, cfg, exec_cfg)
        sts.append(st)
        cvs.append(cv)
        if _is_tap(cfg, l):
            tap = l // cfg.hybrid_attn_every
            h, _, _ = attention_decode_block(
                sp["attn"], rmsnorm(sp["norm"], x[:, None], cfg.norm_eps), cache["k"][tap],
                cache["v"][tap], pos, prope, cfg, exec_cfg)
            x = x + h[:, 0]
    logits = _final_logits(params, x, cfg)
    return logits, {"ssm_state": torch.stack(sts), "conv_state": torch.stack(cvs),
                    "k": cache["k"], "v": cache["v"], "pos": pos + 1}


def serve_step_paged(params: Params, pages_k, pages_v, tables, lengths, tokens,
                     cfg: ModelConfig, exec_cfg: ExecConfig = DEFAULT_EXEC,
                     max_len: int = 0):
    """One gather-free decode step straight off PagedKVPool storage.

    pages_k/pages_v: (L, NBp, KV, bs, D) - the pool's page arrays; tables:
    (B, NB) int32 dump-padded block tables; lengths: (B,) cached tokens per
    sequence; tokens: (B,); max_len: batch-max length including the new
    token. Returns (logits (B, V), k_tok (L, B, KV, D), v_tok) - the step's
    own K/V for `scatter_append`. Dense and moe: a decode step feeds its B
    tokens through the experts as one group either way. Spans:
    `model.forward`, a `model.attn` a layer."""
    _serving(params, cfg, exec_cfg, "serve_step_paged", ("dense", "moe"))
    with tracing.span("model.forward"):
        x = embed_tokens(params["tok"], tokens)[:, None, :]            # (B, 1, D)
        prope = lengths[:, None]
        kts, vts = [], []
        for l, lp in enumerate(params["layers"]):
            with tracing.span("model.attn"):
                h, kt, vt = attention_paged_decode_block(
                    lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps), pages_k[l],
                    pages_v[l], tables, lengths, prope, cfg, exec_cfg, max_len=max_len)
            x = _ffn(lp, x + h, cfg, exec_cfg)
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
    v_c) for `scatter_chunk`. Spans: `model.forward`, a `model.attn` a
    layer."""
    _serving(params, cfg, exec_cfg, "prefill_chunk_paged", ("dense",))
    with tracing.span("model.forward"):
        x = embed_tokens(params["tok"], tokens[None, :])               # (1, C, D)
        kcs, vcs = [], []
        for l, lp in enumerate(params["layers"]):
            with tracing.span("model.attn"):
                h, kt, vt = attention_paged_chunk_block(
                    lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps), pages_k[l],
                    pages_v[l], table, ctx0, cfg, exec_cfg)
            x = _ffn(lp, x + h, cfg, exec_cfg)
            kcs.append(kt[0].transpose(0, 1))
            vcs.append(vt[0].transpose(0, 1))
        logits = _final_logits(params, x[:, -1:], cfg)[:, 0]
        return logits, torch.stack(kcs), torch.stack(vcs)


def extend_step(params: Params, cache: Cache, tokens, cfg: ModelConfig,
                exec_cfg: ExecConfig = DEFAULT_EXEC) -> tuple[torch.Tensor, Cache]:
    """K new tokens (B, K) against an existing cache (speculative verify, or
    a recurrent family's chunked decode): (logits (B, K, V), cache with their
    K/V written, the recurrent states advanced through the K tokens, and
    `pos` advanced by K)."""
    _serving(params, cfg, exec_cfg, "extend_step")
    pos = cache["pos"]
    x = embed_tokens(params["tok"], tokens)
    if cfg.family not in ATTENTION:
        x, pieces = _recurrent_segment(params, cache, x, cfg, exec_cfg)
        return _final_logits(params, x, cfg), {**pieces, "pos": pos + tokens.shape[1]}
    for l, lp in enumerate(params["layers"]):
        h, _, _ = attention_extend_block(
            lp["attn"], rmsnorm(lp["norm1"], x, cfg.norm_eps), cache["k"][l],
            cache["v"][l], pos, cfg, exec_cfg)
        x = _ffn(lp, x + h, cfg, exec_cfg)
    logits = _final_logits(params, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + tokens.shape[1]}
