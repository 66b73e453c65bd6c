"""The Mamba2 SSD recurrence over a segment of T tokens.

`mamba2_ssd` launches the CUDA kernel `csrc/mamba2_ssd.cu` for a tensor on
the card and takes the plain PyTorch version for a tensor on the CPU. The
kernel replaces the TPU kernel `mamba2_ssd_htp` of
src/repro/kernels/mamba2_ssd.py: per (sequence, head), with an N x P fp32
state S and B, C shared by the heads,

    la_t = clip(-e^{a_log} dt_t, -1, 0),   S_t = e^{la_t} S_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T S_t,

in the model's layouts (x (B, T, H, P), B/C (B, T, N), dt (B, T, H)), for
any T, from `state0` (zeros if None); it returns y and the final state, both
fp32. bf16 inputs take the kernel's chunked form on the tensor cores
(KERNEL_CHUNK tokens a chunk, half that at N = P = 128, where the tiles of
KERNEL_CHUNK tokens do not fit a block's shared memory; products kept at
fp32 accuracy by splitting each fp32 operand into three bf16 terms); fp32
inputs take its per-token form on the CUDA cores. The chunked form copies
xh, B and C in 16-byte pieces, so it refuses a tensor that does not start
on a 16-byte boundary; and it needs la >= -1, which the clamp inside the
kernel guarantees.

`ssd_chunked_math` is the reference's chunked form (src/repro/models/
mamba2.py `ssd_chunked`) op for op: its intra-chunk tensors stay in the
dtype of `xh`. The model's use_kernels=False path runs it in the activation
dtype (on the CPU only); the kernel's plain version `ssd_plain` runs it on
fp32 copies of the inputs, the function the kernel computes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

DECAY_CLAMP = 1.0
CHUNK = 128  # fp32-safe with la >= -1 (exponents <= 1 * 128 / 2 = 64)
KERNEL_CHUNK = 64  # the CUDA kernel's chunk (csrc/mamba2_ssd.cu CHUNK)

KERNEL = build.CudaKernel(
    "mamba2_ssd", "mamba2_ssd_launch", [build.PTR] * 8 + [build.INT] * 6 + [build.PTR])


def mamba2_ssd(xh, b_in, c_in, dt, a_log, state0=None):
    """xh: (B, T, H, P), b_in/c_in: (B, T, N), dt: (B, T, H) fp32, a_log:
    (H,) fp32, state0: (B, H, N, P) fp32 or None -> (y (B, T, H, P) fp32,
    state)."""
    if xh.is_cuda:
        return mamba2_ssd_cuda(xh, b_in, c_in, dt, a_log, state0)
    return ssd_plain(xh, b_in, c_in, dt, a_log, state0)


def mamba2_ssd_cuda(xh, b_in, c_in, dt, a_log, state0=None):
    """The hand-written kernel; raises on anything it does not take."""
    if not xh.is_cuda:
        raise ValueError("mamba2_ssd_cuda needs CUDA tensors")
    b, t, h, p = xh.shape
    n = b_in.shape[-1]
    build.check_float("xh", xh)
    build.check_state_dim("state size N", n)
    build.check_state_dim("head channels P", p)
    build.check("xh", xh, (b, t, h, p), xh.dtype, xh.device)
    build.check("b_in", b_in, (b, t, n), xh.dtype, xh.device)
    build.check("c_in", c_in, (b, t, n), xh.dtype, xh.device)
    build.check("dt", dt, (b, t, h), torch.float32, xh.device)
    build.check("a_log", a_log, (h,), torch.float32, xh.device)
    if state0 is not None:
        build.check("state0", state0, (b, h, n, p), torch.float32, xh.device)
    if xh.dtype == torch.bfloat16:
        for name, a in (("xh", xh), ("b_in", b_in), ("c_in", c_in)):
            build.check_aligned(name, a)
    y = torch.empty((b, t, h, p), dtype=torch.float32, device=xh.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=xh.device)
    KERNEL.launch(xh.data_ptr(), b_in.data_ptr(), c_in.data_ptr(), dt.data_ptr(),
                  a_log.data_ptr(), None if state0 is None else state0.data_ptr(),
                  y.data_ptr(), state.data_ptr(), b, t, h, n, p, build.is_bf16(xh),
                  build.stream_ptr(xh))
    return y, state


def ssd_plain(xh, b_in, c_in, dt, a_log, state0=None):
    """The plain version: the chunked form on fp32 copies of the inputs."""
    return ssd_chunked_math(xh.float(), b_in.float(), c_in.float(), dt.float(),
                            a_log.float(), state0)


def ssd_chunked_math(xh, b_in, c_in, dt, a_log, state0=None, chunk: int = CHUNK):
    """The chunked SSD scan, intra-chunk tensors in xh's dtype, cumulative
    decays and the carried state in fp32. Returns (y (B, T, H, P) fp32,
    final state (B, H, N, P))."""
    bsz, t, h, p = xh.shape
    n = b_in.shape[-1]
    if t % chunk:
        # pad to a chunk multiple: dt = 0 kills both the state update and the
        # decay (la = -e^{a_log} * 0 = 0), making the padding exact
        pad = chunk - t % chunk
        y, state = ssd_chunked_math(
            F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(b_in, (0, 0, 0, pad)),
            F.pad(c_in, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), a_log, state0, chunk)
        return y[:, :t], state
    nc = t // chunk
    cdt = xh.dtype
    la = torch.clamp(-torch.exp(a_log) * dt, -DECAY_CLAMP, 0.0)    # (B,T,H) f32
    la = la.reshape(bsz, nc, chunk, h)
    dtc = dt.reshape(bsz, nc, chunk, h)
    xc = xh.reshape(bsz, nc, chunk, h, p)
    bc = b_in.reshape(bsz, nc, chunk, n)
    cc = c_in.reshape(bsz, nc, chunk, n)

    cum = torch.cumsum(la, dim=2)                      # inclusive (B,nc,Lc,H)
    m = cum[:, :, -1]                                  # (B,nc,H)
    half = 0.5 * m[:, :, None]

    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i.B_j) x_j;
    # the masked half is selected away, never multiplied
    c_f = cc[..., None, :] * torch.exp(cum - half)[..., None].to(cdt)
    b_f = bc[..., None, :] * (torch.exp(half - cum) * dtc)[..., None].to(cdt)
    scores = torch.einsum("bcihn,bcjhn->bchij", c_f, b_f)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=xh.device))
    scores = torch.where(mask, scores, 0.0)
    # the reference's preferred_element_type=f32: exact products, fp32 sums
    y = torch.einsum("bchij,bcjhp->bcihp", scores.float(), xc.float())

    # inter-chunk state recurrence
    s = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=xh.device)
         if state0 is None else state0.float())
    c_st = cc[..., None, :] * torch.exp(cum)[..., None].to(cdt)
    b_st = bc[..., None, :] * (torch.exp(m[:, :, None] - cum) * dtc)[..., None].to(cdt)
    y_state = []
    for c in range(nc):
        y_state.append(torch.einsum("blhn,bhnp->blhp", c_st[:, c].float(), s))
        s = s * torch.exp(m[:, c])[..., None, None] + torch.einsum(
            "blhn,blhp->bhnp", b_st[:, c].float(), xc[:, c].float())
    y = y + torch.stack(y_state, dim=1)
    return y.reshape(bsz, t, h, p), s
