"""The RWKV6 WKV recurrence over a segment of T tokens.

`rwkv6_wkv` launches the CUDA kernel `csrc/rwkv6_wkv.cu` for a tensor on the
card and takes the plain PyTorch version for a tensor on the CPU. The kernel
replaces the TPU kernel `rwkv6_wkv_htn` of src/repro/kernels/rwkv6_wkv.py:
per (sequence, head), with an N x N fp32 state S,

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(e^{logw_t}) S_{t-1} + k_t v_t^T,

in the model's (B, T, H, N) layout, for any T, from `state0` (zeros if None);
it returns y and the final state, both fp32. bf16 inputs take the kernel's
chunked form on the tensor cores (CHUNK tokens a chunk, products kept at
fp32 accuracy by splitting each fp32 operand into bf16 terms); fp32 inputs
take its per-token form on the CUDA cores. The chunked form copies r, k, v
and logw in 16-byte pieces, so it refuses a tensor that does not start on a
16-byte boundary; and it needs logw >= -8 (the model's clamp,
models/rwkv6.py `_decay`) so that its exponents stay fp32-safe, which the
kernel does not check.

`wkv_chunked_plain` is the plain version: the reference's chunked form
(src/repro/models/rwkv6.py `wkv_chunked`), fp32 throughout, op for op. The
model's use_kernels=False path runs it too (training on either device,
serving on the CPU only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

CHUNK = 16  # fp32-safe with logw >= -8 (exponents <= 8 * 16 / 2 = 64)

KERNEL = build.CudaKernel(
    "rwkv6_wkv", "rwkv6_wkv_launch", [build.PTR] * 8 + [build.INT] * 5 + [build.PTR])


def rwkv6_wkv(r, k, v, logw, u, state0=None):
    """r/k/v: (B, T, H, N), logw: (B, T, H, N) fp32 <= 0, u: (H, N) fp32,
    state0: (B, H, N, N) fp32 or None -> (y (B, T, H, N) fp32, state)."""
    if r.is_cuda:
        return rwkv6_wkv_cuda(r, k, v, logw, u, state0)
    return wkv_chunked_plain(r, k, v, logw, u, state0)


def rwkv6_wkv_cuda(r, k, v, logw, u, state0=None):
    """The hand-written kernel; raises on anything it does not take."""
    if not r.is_cuda:
        raise ValueError("rwkv6_wkv_cuda needs CUDA tensors")
    b, t, h, n = r.shape
    build.check_float("r", r)
    build.check_state_dim("head size N", n)
    for name, a in (("r", r), ("k", k), ("v", v)):
        build.check(name, a, (b, t, h, n), r.dtype, r.device)
    build.check("logw", logw, (b, t, h, n), torch.float32, r.device)
    build.check("u", u, (h, n), torch.float32, r.device)
    if state0 is not None:
        build.check("state0", state0, (b, h, n, n), torch.float32, r.device)
    if r.dtype == torch.bfloat16:
        for name, a in (("r", r), ("k", k), ("v", v), ("logw", logw)):
            build.check_aligned(name, a)
    y = torch.empty((b, t, h, n), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    KERNEL.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                  u.data_ptr(), None if state0 is None else state0.data_ptr(),
                  y.data_ptr(), state.data_ptr(), b, t, h, n, build.is_bf16(r),
                  build.stream_ptr(r))
    return y, state


def wkv_chunked_plain(r, k, v, logw, u, state0=None, chunk: int = CHUNK):
    """The chunked WKV6 form in fp32: intra-chunk scores with the decays
    centred at half the chunk's total, the u bonus on the diagonal, and the
    state carried across chunks. Returns (y (B, T, H, N) fp32, state)."""
    b, t, h, n = r.shape
    if t % chunk:
        # pad to a chunk multiple: k = 0 (no state contribution) and
        # logw = 0 (no decay) make the padding exact; padded rows are cut
        pz = (0, 0, 0, 0, 0, chunk - t % chunk)
        y, state = wkv_chunked_plain(F.pad(r, pz), F.pad(k, pz), F.pad(v, pz),
                                     F.pad(logw, pz), u, state0, chunk)
        return y[:, :t], state
    nc = t // chunk
    rf, kf, vf = (a.float().reshape(b, nc, chunk, h, n) for a in (r, k, v))
    lw = logw.float().reshape(b, nc, chunk, h, n)
    uf = u.float()

    cum = torch.cumsum(lw, dim=2)                     # inclusive, (B,nc,Lc,H,N)
    cum_ex = cum - lw                                  # exclusive
    m = cum[:, :, -1]                                  # (B,nc,H,N) chunk total
    half = 0.5 * m[:, :, None]

    # intra-chunk: scores_ij = sum_d r_i k_j exp(cum_ex_i - cum_j), j < i;
    # the masked half can overflow, so it is selected away, never multiplied
    a_in = rf * torch.exp(cum_ex - half)
    b_in = kf * torch.exp(half - cum)
    scores = torch.einsum("bcihn,bcjhn->bchij", a_in, b_in)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device), -1)
    scores = torch.where(mask, scores, 0.0)
    y = torch.einsum("bchij,bcjhn->bcihn", scores, vf)
    diag = torch.einsum("bcihn,bcihn->bcih", rf, uf * kf)   # current-token bonus
    y = y + diag[..., None] * vf

    # inter-chunk recurrence: the state carried from chunk to chunk
    s = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    a_st = rf * torch.exp(cum_ex)
    k_st = kf * torch.exp(m[:, :, None] - cum)         # decayed to chunk end
    y_state = []
    for c in range(nc):
        y_state.append(torch.einsum("blhn,bhnm->blhm", a_st[:, c], s))
        s = s * torch.exp(m[:, c])[..., None] + torch.einsum(
            "blhn,blhm->bhnm", k_st[:, c], vf[:, c])
    y = y + torch.stack(y_state, dim=1)
    return y.reshape(b, t, h, n), s
