"""RWKV6 "Finch" (arXiv:2404.05892): attention-free time-mix with
data-dependent per-channel decay, plus the channel-mix FFN; the port of
src/repro/models/rwkv6.py.

Recurrence (per head, head_dim = n):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T            S in R^{n x n}
    y_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})

With `exec_cfg.use_kernels` (the port's default) a whole segment's WKV goes
through `kernels/ops.py`: the hand-written kernel on the card, its plain
version on the CPU. Without it the reference's chunked form runs, which the
port keeps for the CPU only. The one-token step (decode) is plain torch, as
the reference's is plain jnp.

Per-channel log-decays are clamped to [-DECAY_CLAMP, -1e-4] (`_decay`), so
the chunked form's centred factors stay fp32-safe.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.rwkv6_wkv import CHUNK, wkv_chunked_plain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    DEFAULT_EXEC,
    ExecConfig,
    normal,
    plain_only,
    rmsnorm,
    torch_dtype,
)

DECAY_CLAMP = 8.0


def init_time_mix(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    r = cfg.rwkv
    h = d // r.head_dim
    dtype, dev = torch_dtype(cfg), gen.device
    s = d ** -0.5
    f32 = torch.float32

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=dev)

    return {
        "mu_x": full((d,), 0.5),
        "mus": full((5, d), 0.5),
        "lora_mix_a": normal(gen, (d, 5, r.lora_dim_mix), s, f32),
        "lora_mix_b": normal(gen, (5, r.lora_dim_mix, d), 0.01, f32),
        "w0": full((d,), 0.5),  # exp(0.5) ~ 1.65 decay rate
        "lora_w_a": normal(gen, (d, r.lora_dim_decay), s, f32),
        "lora_w_b": normal(gen, (r.lora_dim_decay, d), 0.01, f32),
        "wr": normal(gen, (d, d), s, dtype),
        "wk": normal(gen, (d, d), s, dtype),
        "wv": normal(gen, (d, d), s, dtype),
        "wg": normal(gen, (d, d), s, dtype),
        "wo": normal(gen, (d, d), s, dtype),
        "u": normal(gen, (h, r.head_dim), 0.1, f32),
        "ln_x": full((d,), 1.0),
    }


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dtype, dev = torch_dtype(cfg), gen.device
    return {
        "mu_k": torch.full((d,), 0.5, dtype=torch.float32, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=torch.float32, device=dev),
        "wk": normal(gen, (d, f), d ** -0.5, dtype),
        "wv": normal(gen, (f, d), f ** -0.5, dtype),
        "wr": normal(gen, (d, d), d ** -0.5, dtype),
    }


def _ddlerp(p: dict, x, x_prev):
    """Data-dependent token-shift interpolation -> the 5 mixed inputs."""
    dt = x.dtype
    xx = (x_prev - x).float()
    xf = x.float()
    base = xf + xx * p["mu_x"]
    lora = torch.tanh(torch.einsum("...d,dkl->...kl", base, p["lora_mix_a"]))
    dyn = torch.einsum("...kl,kld->...kd", lora, p["lora_mix_b"])   # (..., 5, d)
    mixed = xf[..., None, :] + xx[..., None, :] * (p["mus"] + dyn)
    return [mixed[..., i, :].to(dt) for i in range(5)]


def _decay(p: dict, xw):
    """Per-channel log-decay log(w_t) in [-DECAY_CLAMP, -1e-4], fp32."""
    lw = torch.tanh(xw.float() @ p["lora_w_a"]) @ p["lora_w_b"]
    rate = torch.exp(torch.clamp(p["w0"] + lw, -6.0, math.log(DECAY_CLAMP)))
    return -torch.clamp(rate, 1e-4, DECAY_CLAMP)


def wkv_chunked(r, k, v, logw, u, state0=None, chunk: int = CHUNK):
    """Chunked WKV6 (the use_kernels=False math). r/k/v/logw: (B, T, H, N),
    u: (H, N), state0: (B, H, N, N) fp32 or None -> (y fp32, final state)."""
    plain_only(r, "wkv_chunked")
    return wkv_chunked_plain(r, k, v, logw, u, state0, chunk)


def wkv_step(r, k, v, logw, u, state):
    """One-token WKV6 recurrence (decode). r/k/v/logw: (B, H, N), state:
    (B, H, N, N) fp32 indexed [key_dim, value_dim] -> (y fp32, state)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = torch.einsum("bhn,bhm->bhnm", kf, vf)
    y = torch.einsum("bhn,bhnm->bhm", rf, state + u[..., None] * kv)
    return y, state * torch.exp(logw)[..., None] + kv


def _mixed_projections(p: dict, x, x_prev, cfg: ModelConfig):
    """r, k, v (..., H, N), the gate g and the log-decay logw (..., H, N)."""
    n = cfg.rwkv.head_dim
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
    heads = x.shape[:-1] + (cfg.d_model // n, n)
    rr = (xr @ p["wr"]).reshape(heads)
    kk = (xk @ p["wk"]).reshape(heads)
    vv = (xv @ p["wv"]).reshape(heads)
    g = F.silu(xg @ p["wg"])
    return rr, kk, vv, g, _decay(p, xw).reshape(heads)


def time_mix(p: dict, x, x_prev, state0, cfg: ModelConfig,
             exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Full-segment time-mix. x: (B, T, D), x_prev: (B, D) carry from the
    previous token (or zeros). Returns (out, (last_x, final_state))."""
    b, t, d = x.shape
    shifted = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    rr, kk, vv, g, logw = _mixed_projections(p, x, shifted, cfg)
    if exec_cfg.use_kernels:
        y, state = kops.rwkv6_wkv(rr, kk, vv, logw, p["u"], state0, impl=exec_cfg.impl)
    else:
        y, state = wkv_chunked(rr, kk, vv, logw, p["u"], state0)
    y = rmsnorm(p["ln_x"], y.reshape(b, t, d), cfg.norm_eps).to(x.dtype) * g
    return y @ p["wo"], (x[:, -1], state)


def time_mix_step(p: dict, x, x_prev, state, cfg: ModelConfig):
    """One-token time-mix. x: (B, D). Returns (out, x, state)."""
    b, d = x.shape
    rr, kk, vv, g, logw = _mixed_projections(p, x, x_prev, cfg)
    y, state = wkv_step(rr, kk, vv, logw, p["u"], state)
    y = rmsnorm(p["ln_x"], y.reshape(b, d), cfg.norm_eps).to(x.dtype) * g
    return y @ p["wo"], x, state


def channel_mix_step(p: dict, x, x_prev):
    """RWKV channel-mix of x (..., D) against the shifted x_prev (..., D).
    Returns (out, x)."""
    xx = x_prev - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    kk = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"]), x


def channel_mix(p: dict, x, x_prev):
    """RWKV channel-mix. x: (B, T, D), x_prev: (B, D). Returns (out, last_x)."""
    shifted = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    out, _ = channel_mix_step(p, x, shifted)
    return out, x[:, -1]
