"""Shared building blocks of the dense decoder: RMSNorm, RoPE, SwiGLU,
embedding and LM head, and their torch init.

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

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution knobs threaded through the model code.

    use_kernels routes attention through `kernels/ops.py`: on the card the
    hand-written kernels, on the CPU their plain versions. It defaults to
    True here (the reference defaults to False), so the serving engine's
    paged="auto" takes the paged path and attention reaches the kernels on
    the card. use_kernels=False selects the reference's blocked math, which
    the port keeps as a CPU-only plain path: on a CUDA tensor it raises.

    impl is handed to every `kernels/ops.py` call: "auto" (a CUDA tensor
    launches the kernel, a CPU tensor takes the plain version) or "torch"
    (the plain version on either device, which `chip_smoke.py` uses to hold
    the kernel path against it on the card).
    """

    q_block: int = 1024          # attention query-block length (plain path)
    use_kernels: bool = True
    impl: str = "auto"


DEFAULT_EXEC = ExecConfig()


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
    stays in the input dtype."""
    dt = x.dtype
    ms = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(ms + eps).to(dt)
    return x * scale * g.to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) int -> (sin, cos) of shape (..., S, head_dim/2), fp32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                      device=positions.device), exps)
    ang = positions.float()[..., None] * inv_freq
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
    return p["embed"][tokens]


def lm_logits(p: dict, x):
    w = p.get("lm_head", p["embed"])
    return x @ w.T
