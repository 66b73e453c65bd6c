"""Mamba2 (SSD) mixer for the Zamba2 hybrid (arXiv:2411.15242); the port of
src/repro/models/mamba2.py.

Selective state-space recurrence (per head, state N, head channels P):
    h_t = a_t h_{t-1} + dt_t * B_t x_t^T         h in R^{N x P},  a_t = exp(A dt_t)
    y_t = C_t^T h_t + D * x_t

With `exec_cfg.use_kernels` (the port's default) a whole segment's SSD goes
through `kernels/ops.py`: the hand-written kernel on the card, its plain
version on the CPU. Without it the reference's chunked form runs in the
activation dtype: the training path on either device, the serving entry
points on the CPU only. The one-token step (decode) and the causal
convolution are plain torch, as the reference's are plain jnp. B and C are shared across heads (n_groups=1), matching Zamba2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.tensor_parallel import per_head_region
from repro_torch.kernels import ops as kops
from repro_torch.kernels.mamba2_ssd import DECAY_CLAMP, ssd_chunked_math
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    DEFAULT_EXEC,
    ExecConfig,
    normal,
    rmsnorm,
    torch_dtype,
)


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.state_dim
    return d_inner, nheads, conv_ch


def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Per-segment projections (z / x / B / C / dt kept as separate
    weights, as in the reference)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, _ = dims(cfg)
    dtype, dev = torch_dtype(cfg), gen.device
    sc = d ** -0.5
    f32 = torch.float32
    return {
        "w_z": normal(gen, (d, d_inner), sc, dtype),
        "w_x": normal(gen, (d, d_inner), sc, dtype),
        "w_b": normal(gen, (d, s.state_dim), sc, dtype),
        "w_c": normal(gen, (d, s.state_dim), sc, dtype),
        "w_dt": normal(gen, (d, nheads), sc, dtype),
        "conv_x": normal(gen, (s.conv_width, d_inner), 0.5, dtype),
        "conv_b": normal(gen, (s.conv_width, s.state_dim), 0.5, dtype),
        "conv_c": normal(gen, (s.conv_width, s.state_dim), 0.5, dtype),
        "conv_bias_x": torch.zeros(d_inner, dtype=dtype, device=dev),
        "conv_bias_b": torch.zeros(s.state_dim, dtype=dtype, device=dev),
        "conv_bias_c": torch.zeros(s.state_dim, dtype=dtype, device=dev),
        # A = -exp(a_log)
        "a_log": torch.log(torch.linspace(1.0, 8.0, nheads, dtype=f32, device=dev)),
        "dt_bias": torch.full((nheads,), -2.0, dtype=f32, device=dev),  # softplus(-2) ~ 0.13
        "d_skip": torch.ones(nheads, dtype=f32, device=dev),
        "norm": torch.ones(d_inner, dtype=f32, device=dev),
        "out_proj": normal(gen, (d_inner, d), d_inner ** -0.5, dtype),
    }


def causal_conv(xbc, w, b, prev=None):
    """Depthwise causal conv, width W. xbc: (B, T, C), w: (W, C); `prev` is
    the (B, W-1, C) tail of the previous segment (decode carry). Returns
    (out, new_prev)."""
    width = w.shape[0]
    bsz, t, c = xbc.shape
    if prev is None:
        prev = torch.zeros((bsz, width - 1, c), dtype=xbc.dtype, device=xbc.device)
    padded = torch.cat([prev, xbc], dim=1)
    out = sum(padded[:, i:i + t] * w[i] for i in range(width)) + b
    return F.silu(out), padded[:, -(width - 1):]


def ssd_chunked(xh, b_in, c_in, dt, a_log, state0=None, chunk: int = 128):
    """Chunked SSD scan (the use_kernels=False math), intra-chunk tensors in
    the activation dtype. xh: (B, T, H, P), b_in/c_in: (B, T, N), dt:
    (B, T, H) fp32, state0: (B, H, N, P) fp32 or None -> (y fp32, state).
    DTensor inputs (a step on a mesh) run on each rank's shards."""
    if isinstance(xh, DTensor):
        bh, b_, h = (0, 2), (0, None), (None, 0)
        return per_head_region(ssd_chunked_math, xh, xh.shape[2],
                               (xh, b_in, c_in, dt, a_log, state0, chunk),
                               (bh, b_, b_, bh, h, (0, 1), (None, None)), (bh, (0, 1)))
    return ssd_chunked_math(xh, b_in, c_in, dt, a_log, state0, chunk)


def ssd_step(xh, b_in, c_in, dt, a_log, state):
    """One-token SSD step. xh: (B, H, P), b_in/c_in: (B, N), dt: (B, H)
    fp32, state: (B, H, N, P) fp32 -> (y fp32, state)."""
    la = torch.clamp(-torch.exp(a_log) * dt, -DECAY_CLAMP, 0.0)
    xf = xh.float()
    upd = torch.einsum("bn,bhp->bhnp", b_in.float(), xf * dt[..., None])
    state = state * torch.exp(la)[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c_in.float(), state)
    return y, state


def _conv_inputs(p: dict, x, conv_prev, cfg: ModelConfig):
    """The three causal convolutions (x, B, C) of x (B, T, D) from the carried
    tail `conv_prev` (B, W-1, C) or zeros. Returns (xs, b_in, c_in,
    conv_state)."""
    d_inner, _, _ = dims(cfg)
    n = cfg.ssm.state_dim
    if conv_prev is None:
        cp_x = cp_b = cp_c = None
    else:
        cp_x, cp_b, cp_c = torch.split(conv_prev, [d_inner, n, n], dim=-1)
    xs, cs_x = causal_conv(x @ p["w_x"], p["conv_x"], p["conv_bias_x"], cp_x)
    b_in, cs_b = causal_conv(x @ p["w_b"], p["conv_b"], p["conv_bias_b"], cp_b)
    c_in, cs_c = causal_conv(x @ p["w_c"], p["conv_c"], p["conv_bias_c"], cp_c)
    return xs, b_in, c_in, torch.cat([cs_x, cs_b, cs_c], dim=-1)


def _gated_out(p: dict, y, xh, z, x_dtype, cfg: ModelConfig):
    """y + D * x, RMSNorm, SiLU(z) gate, out projection."""
    y = y + p["d_skip"][:, None] * xh.float()
    y = y.reshape(*z.shape)
    y = rmsnorm(p["norm"], y.to(x_dtype), cfg.norm_eps) * F.silu(z)
    return y @ p["out_proj"]


def mamba2_block(p: dict, x, cfg: ModelConfig, state0=None, conv_prev=None,
                 exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Full-segment Mamba2 block. x: (B, T, D). Returns (out, (ssm_state,
    conv_state))."""
    s = cfg.ssm
    _, nheads, _ = dims(cfg)
    bsz, t, _ = x.shape
    z = x @ p["w_z"]
    dt_raw = x @ p["w_dt"]
    xs, b_in, c_in, conv_state = _conv_inputs(p, x, conv_prev, cfg)
    xh = xs.reshape(bsz, t, nheads, s.head_dim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    if exec_cfg.use_kernels:
        y, state = kops.mamba2_ssd(xh, b_in, c_in, dt, p["a_log"], state0,
                                   impl=exec_cfg.impl)
    else:
        y, state = ssd_chunked(xh, b_in, c_in, dt, p["a_log"], state0, chunk=s.chunk_size)
    return _gated_out(p, y, xh, z, x.dtype, cfg), (state, conv_state)


def mamba2_step(p: dict, x, state, conv_prev, cfg: ModelConfig):
    """One-token Mamba2 step. x: (B, D), state: (B, H, N, P), conv_prev:
    (B, W-1, C). Returns (out, (ssm_state, conv_state))."""
    s = cfg.ssm
    _, nheads, _ = dims(cfg)
    bsz = x.shape[0]
    z = x @ p["w_z"]
    dt_raw = x @ p["w_dt"]
    xs, b_in, c_in, conv_state = _conv_inputs(p, x[:, None], conv_prev, cfg)
    xh = xs[:, 0].reshape(bsz, nheads, s.head_dim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    y, state = ssd_step(xh, b_in[:, 0], c_in[:, 0], dt, p["a_log"], state)
    return _gated_out(p, y, xh, z, x.dtype, cfg), (state, conv_state)
