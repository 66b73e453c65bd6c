"""Shared building blocks of the decoders: RMSNorm, RoPE and M-RoPE, SwiGLU,
the routed mixture of experts, embedding and LM head, and their torch init.

Plain functions over parameter dicts of tensors, as in the reference
(src/repro/models/layers.py). Activations flow in `cfg.dtype`; reductions
that need range (the norm's mean square, softmax) run in fp32 and cast back.
Init draws from an explicit `torch.Generator` on the device the weights go
to; the draws differ from the reference's `jax.random` ones, so parity tests
bridge the reference's weights instead (`repro_torch.weights`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.tensor_parallel import (
    batch_sum_region,
    expert_parallel_region,
    placed,
    replicate_residual,
    replicated_region,
    spec_placements,
    vocab_parallel_embed,
)
from repro_torch.models.config import ModelConfig, MoEConfig


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution knobs threaded through the model code.

    use_kernels routes attention and the recurrences through
    `kernels/ops.py`: on the card the hand-written kernels, on the CPU their
    plain versions. It defaults to True here (the reference defaults to
    False), so the serving engine's paged="auto" takes the paged path and
    attention reaches the kernels on the card. use_kernels=False selects the
    reference's blocked math: the training path (`TRAIN_EXEC`, `forward`,
    `loss_fn`) on either device; the serving entry points take it on the
    CPU only (`serving_guard`).

    impl is handed to every `kernels/ops.py` call: "auto" (a CUDA tensor
    launches the kernel, a CPU tensor takes the plain version) or "torch"
    (the plain version on either device, which `chip_smoke.py` uses to hold
    the kernel path against it on the card).

    remat (the reference's default, True) recomputes each layer (each tap
    group for the hybrid) in the backward pass of `forward`, so that only
    layer-boundary activations are saved.

    moe_group_size is the reference's: tokens per MoE dispatch group.

    carry_spec and ep_axes are the reference's sharding knobs, read only
    where the activations are DTensors (the sharded train step and prefill;
    the dry-run sets them). carry_spec, a PartitionSpec-like tuple such as
    (("data",), "model", None), is Megatron-style sequence parallelism: the
    (B, S, D) residual stream is placed so at every layer boundary
    (`constrain_carry`), its sequence over "model", which divides the saved
    remat carries by that axis's size. It also sends the MoE through the
    hand-placed dispatch (`tensor_parallel.expert_parallel_region`). ep_axes
    (mesh axes whose size divides num_experts; `sharding.ep_axes_for`)
    lays that dispatch out expert-major over those axes, one all-to-all each
    way, so each rank runs its own experts on its own banks.
    """

    q_block: int = 1024          # attention query-block length (plain path)
    use_kernels: bool = True
    impl: str = "auto"
    remat: bool = True           # checkpoint each layer during training
    moe_group_size: int = 4096   # tokens per MoE dispatch group
    carry_spec: tuple | None = None   # the residual stream's placement on a mesh
    ep_axes: tuple | None = None      # expert-parallel axes of the MoE dispatch


DEFAULT_EXEC = ExecConfig()


# the reference's training mode: its blocked math, each layer recomputed in
# the backward pass (src/repro/models/layers.py ExecConfig defaults)
TRAIN_EXEC = ExecConfig(use_kernels=False, remat=True)


def constrain_carry(x, exec_cfg: ExecConfig):
    """x (B, S, D), a DTensor, placed as exec_cfg.carry_spec says: per mesh
    dim, Shard(i) for the tensor dim i that names its axis, else Replicate
    (a partial sum is reduced: reduce-scattered where the carry shards).
    A plain tensor, or no carry_spec, passes as it is."""
    if exec_cfg.carry_spec is None or not isinstance(x, DTensor):
        return x
    return placed(x, spec_placements(exec_cfg.carry_spec, x.device_mesh.mesh_dim_names))


def serving_guard(x, exec_cfg: ExecConfig, what: str) -> None:
    """The serving entry points take the reference's non-kernel math
    (use_kernels=False) on the CPU only: on the card they go through the
    kernels, and a CUDA tensor raises."""
    if not exec_cfg.use_kernels and x.is_cuda:
        raise ValueError(f"{what} with use_kernels=False runs on the CPU only; "
                         "on the card it goes through the kernels")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, scale^2) draws on the generator's device, cast to `dtype`."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_rmsnorm(d: int, device) -> torch.Tensor:
    return torch.ones(d, dtype=torch.float32, device=device)


def rmsnorm(g, x, eps: float = 1e-5):
    """fp32 only inside the mean-square reduction; the normalize multiply
    stays in the input dtype. A DTensor input (a step on a mesh) is placed
    by its batch shards alone, replicated elsewhere, as Megatron's layers
    feed their column-parallel products: left to DTensor, a later layer's
    products may gather their weights and compute whole on every rank. The
    sequence-parallel carry (x (B, S, D) sharded on S) is normed on its
    shards and its output gathered, in its own dtype; any other input is
    gathered first (a partial sum reduced)."""
    if isinstance(x, DTensor):
        if x.ndim == 3 and any(q.is_shard(1) for q in x.placements):
            return replicate_residual(_rms(g, x, eps))
        x = replicate_residual(x)
    return _rms(g, x, eps)


def _rms(g, x, eps: float):
    dt = x.dtype
    ms = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(ms + eps).to(dt)
    return x * scale * g.to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_angles(positions, head_dim: int, theta: float, m_rope_sections=None):
    """positions (..., S) int, or (3, ..., S) for M-RoPE -> (sin, cos) of
    shape (..., S, head_dim/2), fp32.

    For M-RoPE (qwen2-vl) the leading 3 are the temporal, height and width
    streams, and the rotary frequencies split into the three sections
    (t, h, w): frequency i turns by the position of its section's stream."""
    half = head_dim // 2
    dev = positions.device
    exps = -torch.arange(0, half, dtype=torch.float32, device=dev) / half
    inv_freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=dev), exps)
    if m_rope_sections is None:
        ang = positions.float()[..., None] * inv_freq
        return torch.sin(ang), torch.cos(ang)
    t, h, w = m_rope_sections
    assert t + h + w == half, f"m_rope sections {m_rope_sections} != {half}"
    freq = torch.arange(half, device=dev)
    sec = (freq >= t).long() + (freq >= t + h).long()               # stream of each freq
    pos = torch.movedim(positions, 0, -1).float()                  # (..., S, 3)
    ang = pos[..., sec] * inv_freq                                 # (..., S, half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (B, S, H, D). sin/cos: (B, S, D/2) or (S, D/2)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if sin.dim() == 2:
        s, c = sin[None, :, None, :], cos[None, :, None, :]
    else:
        s, c = sin[:, :, None, :], cos[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def init_swiglu(gen: torch.Generator, d: int, f: int, dtype) -> dict:
    return {
        "w_gate": normal(gen, (d, f), d ** -0.5, dtype),
        "w_up": normal(gen, (d, f), d ** -0.5, dtype),
        "w_down": normal(gen, (f, d), f ** -0.5, dtype),
    }


def swiglu(p: dict, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of experts: routed top-k plus optional shared experts
#
# The reference's capacity dispatch (src/repro/models/layers.py): tokens go
# in groups of `moe_group_size`; each (token, k) unit takes the slot
# expert * C + rank, its rank being its arrival order within its expert;
# units ranked C or later are dropped into an overflow slot. The experts run
# as three batched products over (G, E, C, D). Every expert gets C slots,
# used or not, so a step reads every expert's weights.
# ---------------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    m, d, dtype = cfg.moe, cfg.d_model, torch_dtype(cfg)
    e, f = m.num_experts, m.d_ff_expert
    p = {"router": normal(gen, (d, e), d ** -0.5, torch.float32),
         "w_gate": normal(gen, (e, d, f), d ** -0.5, dtype),
         "w_up": normal(gen, (e, d, f), d ** -0.5, dtype),
         "w_down": normal(gen, (e, f, d), f ** -0.5, dtype)}
    if m.num_shared_experts > 0:
        p["shared"] = init_swiglu(gen, d, m.d_ff_shared, dtype)
    return p


def _moe_capacity(tokens_per_group: int, m: MoEConfig) -> int:
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    return max(c, m.top_k)


def moe_ffn(p: dict, x, cfg: ModelConfig, exec_cfg: ExecConfig = DEFAULT_EXEC):
    """x (B, S, D) -> (B, S, D), the reference's `moe_ffn` op for op, over
    groups of `moe_group_size` contiguous tokens (`moe_groups`). A DTensor x
    (the sharded step) takes the hand-placed expert-parallel dispatch under
    a carry_spec, else runs whole on every rank."""
    m = cfg.moe
    if isinstance(x, DTensor):         # the sharded train step
        if exec_cfg.carry_spec is not None:
            return expert_parallel_region(lambda pl, xg, ex: moe_groups(pl, xg, m, ex),
                                          p, x, exec_cfg, m.num_experts)
        return replicated_region(moe_ffn, p, x, cfg, exec_cfg)
    b, s, d = x.shape
    total = b * s
    tg = min(exec_cfg.moe_group_size, total)
    assert total % tg == 0, f"tokens {total} not divisible by group {tg}"
    return moe_groups(p, x.reshape(total // tg, tg, d), m).reshape(b, s, d)


def moe_groups(p: dict, xg, m: MoEConfig, experts=None):
    """The routed MoE over groups xg (G, Tg, D) -> (G, Tg, D): route, rank,
    drop and scatter each group's units into (G, E, C, D), run the experts,
    combine. experts(ein, fn), if given, runs the expert products fn on the
    dispatch buffer its own way (the expert-parallel exchange)."""
    g, tg, d = xg.shape
    e, dev = m.num_experts, xg.device

    # routing: the router product in the activation dtype, upcast after
    logits = (xg @ p["router"].to(xg.dtype)).float()               # (G, Tg, E)
    gate, expert_idx = torch.topk(torch.softmax(logits, dim=-1), m.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)       # renormalise

    tk = tg * m.top_k
    flat_e = expert_idx.reshape(g, tk)
    cap = _moe_capacity(tg, m)
    # rank of each (token, k) unit within its expert, by a stable argsort
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, sort_idx)
    counts = torch.zeros(g, e, dtype=torch.long, device=dev).scatter_add_(
        -1, flat_e, torch.ones_like(flat_e))
    offsets = counts.cumsum(-1) - counts                           # exclusive
    rank_sorted = torch.arange(tk, device=dev)[None, :] - torch.gather(offsets, -1, sorted_e)
    rank = torch.empty_like(rank_sorted).scatter_(-1, sort_idx, rank_sorted)
    keep = rank < cap                                              # capacity drop
    slot = torch.where(keep, flat_e * cap + rank, e * cap)         # overflow slot

    # dispatch: scatter the units into (G, E*C + 1, D); the overflow row,
    # which dropped units may share, is cut off before the experts
    xu = xg[:, torch.arange(tk, device=dev) // m.top_k]            # (G, TK, D)
    rows = torch.arange(g, device=dev)[:, None]
    buf = torch.zeros(g, e * cap + 1, d, dtype=xg.dtype, device=dev)
    buf[rows, slot] = xu
    ein = buf[:, :e * cap].reshape(g, e, cap, d)

    hout = _moe_experts(p, ein) if experts is None else experts(
        ein, lambda t: _moe_experts(p, t))
    hflat = torch.cat([hout.reshape(g, e * cap, d),
                       torch.zeros(g, 1, d, dtype=hout.dtype, device=dev)], dim=1)

    # combine: each unit's expert output, weighted by gate * keep
    out_u = hflat[rows, slot]                                      # (G, TK, D)
    w = (gate.reshape(g, tk) * keep).to(out_u.dtype)
    out = (out_u * w[..., None]).reshape(g, tg, m.top_k, d).sum(dim=2)
    if m.num_shared_experts > 0:
        out = out + swiglu(p["shared"], xg)
    return out


def _moe_experts(p: dict, ein):
    """The experts' SwiGLUs as three batched products over ein (G, E, C, D)."""
    hgate = torch.einsum("gecd,edf->gecf", ein, p["w_gate"])
    hup = torch.einsum("gecd,edf->gecf", ein, p["w_up"])
    return torch.einsum("gecf,efd->gecd", F.silu(hgate) * hup, p["w_down"])


def _router_probs(p: dict, x, d: int):
    """Router probabilities (T, E) of x (..., d), fp32: the product in the
    activation dtype, only the logits upcast."""
    return torch.softmax((x.reshape(-1, d) @ p["router"].to(x.dtype)).float(), dim=-1)


def _aux_sums(p: dict, x, e: int) -> tuple:
    """(top-1 counts, router probability sums), each (E,), over x's tokens."""
    probs = _router_probs(p, x, x.shape[-1])
    return F.one_hot(probs.argmax(dim=-1), e).float().sum(dim=0), probs.sum(dim=0)


def moe_aux_loss(p: dict, x, cfg: ModelConfig, exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Switch-style load-balancing loss of the router p over x (..., D): E
    times the dot product of each expert's top-1 share and its mean router
    probability. The router product runs in the activation dtype and only the
    (T, E) logits are upcast, as in the reference. A DTensor x takes its
    sums on each rank's tokens under a carry_spec, else runs whole."""
    e = cfg.moe.num_experts
    if isinstance(x, DTensor):         # the sharded train step
        if exec_cfg.carry_spec is None:
            return replicated_region(moe_aux_loss, p, x, cfg)
        counts, sums = batch_sum_region(_aux_sums, p, x, e)
        n = x.numel() // x.shape[-1]
        return e * ((counts / n) * (sums / n)).sum()
    probs = _router_probs(p, x, cfg.d_model)
    frac = F.one_hot(probs.argmax(dim=-1), e).float().mean(dim=0)
    return e * (frac * probs.mean(dim=0)).sum()


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def init_embed(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dtype = torch_dtype(cfg)
    p = {"embed": normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal(gen, (cfg.vocab_size, cfg.d_model),
                              cfg.d_model ** -0.5, dtype)
    return p


def embed_tokens(p: dict, tokens):
    """The table's rows for tokens (...,). F.embedding, whose backward on the
    card sums a row's gradients in a fixed order (an indexing gather's
    accumulates them with atomics, so two runs would differ). A table
    sharded by rows over a mesh (the sharded train step) takes the
    hand-written vocab-parallel lookup of distributed/tensor_parallel.py."""
    if isinstance(p["embed"], DTensor):
        return vocab_parallel_embed(p["embed"], tokens)
    return F.embedding(tokens, p["embed"])


def lm_logits(p: dict, x):
    w = p.get("lm_head", p["embed"])
    return x @ w.T
