"""Model configuration dataclasses + family registry.

One `ModelConfig` describes any architecture in the assigned pool:

  dense  - pre-norm GQA transformer (RoPE, SwiGLU)        glm4/granite/yi/llama
  moe    - dense backbone with routed-expert FFN          llama4-scout, qwen2-moe
  ssm    - RWKV6 "Finch" (attention-free)                 rwkv6-7b
  hybrid - Mamba2 blocks + shared attention taps          zamba2-2.7b
  audio  - decoder-only over EnCodec frames (stub front)  musicgen-medium
  vlm    - text backbone with M-RoPE (stub vision front)  qwen2-vl-72b

Everything downstream (init, forward, serve_step, sharding rules, roofline
analytics) is driven from this one dataclass.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int              # routed experts
    top_k: int
    d_ff_expert: int              # per-expert FFN hidden
    num_shared_experts: int = 0   # always-on experts
    d_ff_shared: int = 0          # total shared-expert hidden width
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer parameters."""

    state_dim: int = 64           # N: per-head SSM state size
    head_dim: int = 64            # P: channels per head
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 128         # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 "Finch" mixer parameters."""

    head_dim: int = 64
    lora_dim_decay: int = 64      # low-rank dim for data-dependent decay w_t
    lora_dim_mix: int = 32        # low-rank dim for token-shift mixing


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 1e6
    # M-RoPE (qwen2-vl): split of rotary dims into (temporal, height, width)
    # sections. None => standard 1-D RoPE.
    m_rope_sections: Optional[tuple[int, int, int]] = None
    causal: bool = True

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int                     # dense-FFN hidden (MoE: see moe.d_ff_expert)
    vocab_size: int
    attn: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (zamba2): one *shared-weight* attention block applied after every
    # `hybrid_attn_every` Mamba2 layers.
    hybrid_attn_every: int = 6
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # Modality frontend stub: None | "audio_frames" | "vision_patches".
    # Stubbed frontends feed precomputed (B, S, d_model) embeddings.
    frontend: Optional[str] = None
    max_seq_len: int = 524_288    # upper bound for RoPE tables etc.

    # ---------------- derived quantities ----------------
    def __post_init__(self):
        if self.family in ("dense", "moe", "audio", "vlm"):
            assert self.attn is not None, f"{self.name}: attention family needs attn cfg"
        if self.family == "moe":
            assert self.moe is not None
        if self.family == "ssm":
            assert self.rwkv is not None
        if self.family == "hybrid":
            assert self.ssm is not None and self.attn is not None

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True for sub-quadratic archs (state-based decode): ssm + hybrid."""
        return self.family in ("ssm", "hybrid")

    @property
    def num_attn_layers(self) -> int:
        """Number of layers that hold a KV cache."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.num_layers // self.hybrid_attn_every
        return self.num_layers

    # -- parameter counting (used by roofline + carbon model) --
    def param_count(self) -> int:
        d = self.d_model
        n = 0
        n += self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            a = self.attn
            per_layer += d * a.q_dim + 2 * d * a.kv_dim + a.q_dim * d
            if self.family == "moe":
                m = self.moe
                per_layer += d * m.num_experts        # router
                per_layer += m.num_experts * 3 * d * m.d_ff_expert
                if m.num_shared_experts:
                    per_layer += 3 * d * m.d_ff_shared
            else:
                per_layer += 3 * d * self.d_ff        # swiglu
            per_layer += 2 * d                        # norms
        elif self.family == "ssm":
            r = self.rwkv
            h = d // r.head_dim
            # time-mix: r/k/v/g/o projections + decay lora + mix loras + u
            per_layer += 5 * d * d
            per_layer += 2 * (d * r.lora_dim_decay + r.lora_dim_decay * d)
            per_layer += 5 * (d * r.lora_dim_mix + r.lora_dim_mix * d)
            per_layer += h * r.head_dim               # u (bonus)
            # channel-mix: k/v/r
            per_layer += d * self.d_ff + self.d_ff * d + d * d
            per_layer += 2 * d
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            # mamba2 block: in_proj (z,x,B,C,dt) + conv + out_proj
            per_layer += d * (2 * d_in + 2 * s.state_dim + nheads)
            per_layer += s.conv_width * (d_in + 2 * s.state_dim)
            per_layer += d_in * d
            per_layer += nheads * 3                   # A, D, dt_bias
            per_layer += 3 * d * self.d_ff            # swiglu ffn
            per_layer += 2 * d
        n += per_layer * self.num_layers
        if self.family == "hybrid":
            a = self.attn
            n += 2 * self.d_model * a.q_dim + 2 * self.d_model * a.kv_dim  # shared attn (applied at taps)
        n += d                                        # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        dense_experts = m.num_experts * 3 * d * m.d_ff_expert
        active_experts = m.top_k * 3 * d * m.d_ff_expert
        return self.param_count() - self.num_layers * (dense_experts - active_experts)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes appended per generated/prefilled token (GQA-aware).

        This is the quantity that drives the Disg-Pref-Decode interconnect
        wall (paper Fig. 4): the whole prefix's KV must cross the link.
        """
        if self.family == "ssm":
            return 0  # constant state, nothing per token
        a = self.attn
        return self.num_attn_layers * 2 * a.num_kv_heads * a.head_dim * dtype_bytes

    def state_bytes(self, dtype_bytes: int = 4) -> int:
        """Constant-size recurrent state per sequence (ssm/hybrid)."""
        if self.family == "ssm":
            r = self.rwkv
            h = self.d_model // r.head_dim
            return self.num_layers * h * r.head_dim * r.head_dim * dtype_bytes
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * self.d_model
            nheads = d_in // s.head_dim
            conv = s.conv_width * (d_in + 2 * s.state_dim)
            return self.num_layers * (nheads * s.head_dim * s.state_dim + conv) * dtype_bytes
        return 0

    def flops_per_token(self, seq_len: int = 0) -> float:
        """Approximate forward FLOPs/token: 2*N_active + attention term."""
        f = 2.0 * self.active_param_count()
        if self.attn is not None and self.family != "ssm":
            layers = self.num_attn_layers
            a = self.attn
            f += 4.0 * layers * a.num_heads * a.head_dim * max(seq_len, 1)
        return f


def head_dim_of(d_model: int, num_heads: int) -> int:
    hd = d_model // num_heads
    assert hd * num_heads == d_model
    return hd


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small: dict = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        d_ff=256,
        vocab_size=512,
        max_seq_len=512,
    )
    if cfg.attn is not None:
        kv = min(cfg.attn.num_kv_heads, 2)
        heads = max(2, min(4, cfg.attn.num_heads))
        heads = max(heads, kv) - (max(heads, kv) % kv)
        small["attn"] = dataclasses.replace(
            cfg.attn,
            num_heads=max(heads, kv),
            num_kv_heads=kv,
            head_dim=128 // max(heads, kv) if 128 % max(heads, kv) == 0 else 32,
        )
        # keep d_model = heads*head_dim relationship simple: use 4 heads x 32
        small["attn"] = dataclasses.replace(
            small["attn"], num_heads=4, num_kv_heads=min(kv, 4), head_dim=32
        )
        if cfg.attn.m_rope_sections is not None:
            small["attn"] = dataclasses.replace(
                small["attn"], m_rope_sections=(8, 4, 4)
            )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=128,
            d_ff_shared=128 if cfg.moe.num_shared_experts else 0,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
        )
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32, chunk_size=32)
    if cfg.rwkv is not None:
        small["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=32, lora_dim_decay=16, lora_dim_mix=8)
    if cfg.family == "hybrid":
        small["hybrid_attn_every"] = 2
        small["num_layers"] = 4
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
