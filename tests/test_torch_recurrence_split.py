"""The recurrence kernels' chunked tensor-core arithmetic, on the CPU.

The bf16 routes of csrc/rwkv6_wkv.cu and csrc/mamba2_ssd.cu walk a segment
chunk by chunk and do their products on mma.sync (bf16 operands, fp32
sums). An fp32 operand is split into three bf16 terms, each rounding what
the ones before it left; a product of two split operands keeps the term
products whose indices sum below three (hi.hi, hi.mid, mid.hi, hi.lo,
mid.mid, lo.hi); a raw bf16 input is exact and needs no split, so a split
operand against it takes three products. WKV's u bonus is a sum on the
CUDA cores, placed on the diagonal of its scores. The ragged last chunk
is masked in place: rows past T read zeros (k = 0 and logw = 0 for WKV,
x = B = C = 0 and dt = 0 for SSD). `model_wkv` and `model_ssd` below
repeat that arithmetic in plain torch, chunk for chunk, and these tests
hold them to the reference's Pallas kernels in interpret mode and to the
per-token fp32 oracles, on bf16-valued inputs from a numpy seed. The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerance: the row-normalised error chip_smoke.py uses (each row's
max|a - b| over the RMS of b's row, the largest over all rows), at or under
chip_smoke.py's bf16 limits: 6e-5 (WKV) and 1e-4 (SSD) against the fp32
oracles, 1.5e-4 against the Pallas kernels. A control runs the SSD model
on two-term operands, which must read farther from the oracle than the
kernel's three.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_wkv as wkv

TOL_ORACLE = {"wkv": 6e-5, "ssd": 1e-4}
TOL_PALLAS = 1.5e-4
TS = (1, 4, 15, 16, 17, 40, 130)
H = 2


def _split(x, terms):
    """fp32 -> `terms` bf16 values (as fp32 tensors) summing to x: each term
    rounds what the ones before it left over."""
    out = []
    for _ in range(terms):
        out.append(x.bfloat16().float())
        x = x - out[-1]
    return out


def _mm(a, b, ka, kb):
    """a @ b on split operands (ka and kb terms; 1 = a raw bf16 input, exact),
    taking the term products (i, j) with i + j < max(ka, kb), smallest first,
    as the kernels' mma_split does."""
    sa = _split(a, ka) if ka > 1 else [a]
    sb = _split(b, kb) if kb > 1 else [b]
    k = max(ka, kb)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for o in range(k - 1, -1, -1):
        for i in range(ka):
            if 0 <= o - i < kb:
                acc = acc + sa[i] @ sb[o - i]
    return acc


def _pad(a, rows):
    """Zero rows past the end along axis 0 (the kernels' zero-filled tile)."""
    return torch.cat([a, a.new_zeros((rows - a.shape[0],) + a.shape[1:])]) \
        if a.shape[0] < rows else a


def model_wkv(r, k, v, logw, u, state0):
    """(B, T, H, N) fp32 (r/k/v bf16-valued) -> (y, state) as the kernel's
    bf16 route computes them, one (sequence, head) at a time: every product
    on 3-term operands (v exact), the scores summed over the warps' 16-column
    parts, the u bonus in fp32 on their diagonal; a_in and b_in serve the
    state's products too, against the state scaled by e^(m/2)."""
    b, t, h, n = r.shape
    lc = wkv.CHUNK
    y = torch.zeros(b, t, h, n)
    state = torch.zeros(b, h, n, n)
    lower = torch.tril(torch.ones(lc, lc, dtype=torch.bool), -1)
    eye = torch.eye(lc, dtype=torch.bool)
    for bi in range(b):
        for hi in range(h):
            s = state0[bi, hi].clone() if state0 is not None else torch.zeros(n, n)
            for t0 in range(0, t, lc):
                rc, kc, vc, lw = (_pad(a[bi, t0:t0 + lc, hi], lc) for a in (r, k, v, logw))
                cum = torch.cumsum(lw, 0)
                cum_ex, m = cum - lw, cum[-1]
                half = 0.5 * m
                a_in, b_in = rc * torch.exp(cum_ex - half), kc * torch.exp(half - cum)
                scores = sum(_mm(a_in[:, w:w + 16], b_in[:, w:w + 16].T, 3, 3)
                             for w in range(0, n, 16))   # each warp's 16 key columns
                bonus = (rc * u[hi] * kc).sum(1)
                scores = torch.where(lower, scores, torch.where(eye, bonus[:, None], 0.0))
                eh = torch.exp(half)[:, None]            # the state is published times e^(m/2)
                s = eh * s
                yc = _mm(a_in, s, 3, 3) + _mm(scores, vc, 3, 1)
                s = eh * (s + _mm(b_in.T, vc, 3, 1))
                y[bi, t0:t0 + lc, hi] = yc[:min(lc, t - t0)]
            state[bi, hi] = s
    return y, state


def model_ssd(x, bm, cm, dt, a_log, state0, lc, terms=3):
    """x (B, T, H, P), B/C (B, T, N) bf16-valued fp32, dt (B, T, H) ->
    (y, state) as the kernel's bf16 route computes them at chunk lc: C . B^T
    exact, every other product on `terms`-term operands against an exact
    bf16 one (x, B, C; the kernel's `terms` is 3)."""
    b, t, h, p = x.shape
    n = bm.shape[-1]
    y = torch.zeros(b, t, h, p)
    state = torch.zeros(b, h, n, p)
    incl = torch.tril(torch.ones(lc, lc, dtype=torch.bool))
    for bi in range(b):
        for hi in range(h):
            s = state0[bi, hi].clone() if state0 is not None else torch.zeros(n, p)
            a = -torch.exp(a_log[hi])
            for t0 in range(0, t, lc):
                xc = _pad(x[bi, t0:t0 + lc, hi], lc)
                bc, cc = (_pad(z[bi, t0:t0 + lc], lc) for z in (bm, cm))
                dc = _pad(dt[bi, t0:t0 + lc, hi], lc)
                cum = torch.cumsum(torch.clamp(a * dc, -ssd.DECAY_CLAMP, 0.0), 0)
                m = cum[-1]
                half = 0.5 * m
                g = cc @ bc.T                         # raw bf16 operands: exact products
                scores = g * torch.exp(cum - half)[:, None] * (torch.exp(half - cum) * dc)[None]
                yc = torch.exp(cum)[:, None] * _mm(cc, s, 1, terms)    # C exact, S split
                yc = yc + _mm(torch.where(incl, scores, 0.0), xc, terms, 1)
                w = torch.exp(m - cum) * dc
                s = s * torch.exp(m) + _mm(bc.T, xc * w[:, None], 1, terms)
                y[bi, t0:t0 + lc, hi] = yc[:min(lc, t - t0)]
            state[bi, hi] = s
    return y, state


def _rowrel(a, b):
    """chip_smoke.py's row-normalised error."""
    a = torch.from_numpy(np.array(a, np.float32))
    b = torch.from_numpy(np.array(b, np.float32))
    d = (a - b).abs().reshape(-1, b.shape[-1])
    rms = b.reshape(-1, b.shape[-1]).pow(2).mean(-1).sqrt()
    return float((d.amax(-1) / rms.clamp_min(1e-6)).max())


def _bf16_valued(rng, *shape, scale=0.5):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)) \
        .bfloat16().float()


def _wkv_case(t, state, n=64, b=1):
    rng = np.random.default_rng(1000 + 10 * t + state)
    r, k, v = (_bf16_valued(rng, b, t, H, n) for _ in range(3))
    logw = torch.from_numpy(np.clip(-np.exp(rng.standard_normal((b, t, H, n)) * 0.5),
                                    -8.0, -1e-4).astype(np.float32))
    u = torch.from_numpy((rng.standard_normal((H, n)) * 0.1).astype(np.float32))
    s0 = torch.from_numpy((rng.standard_normal((b, H, n, n)) * 0.1).astype(np.float32)) \
        if state else None
    return r, k, v, logw, u, s0


def _ssd_case(t, state, p=64, n=64, b=1):
    rng = np.random.default_rng(2000 + 10 * t + state)
    x = _bf16_valued(rng, b, t, H, p)
    bm, cm = (_bf16_valued(rng, b, t, n) for _ in range(2))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((b, t, H)))).astype(np.float32))
    a_log = torch.log(torch.linspace(1.0, 8.0, H))
    s0 = torch.from_numpy((rng.standard_normal((b, H, n, p)) * 0.1).astype(np.float32)) \
        if state else None
    return x, bm, cm, dt, a_log, s0


def _j(a):
    return jnp.asarray(a.numpy())


@pytest.mark.parametrize("state", [True, False])
@pytest.mark.parametrize("t", TS)
def test_wkv_chunk_model_matches_reference(t, state):
    r, k, v, logw, u, s0 = _wkv_case(t, state)
    b, _, h, n = r.shape
    zero = torch.zeros(b, h, n, n) if s0 is None else s0
    got_y, got_s = model_wkv(r, k, v, logw, u, s0)
    tr = lambda a: a.transpose(1, 2)                     # noqa: E731
    ora_y, ora_s = ref.rwkv6_wkv_ref(tr(r), tr(k), tr(v), tr(logw), u, zero)
    assert _rowrel(got_y, tr(ora_y)) < TOL_ORACLE["wkv"]
    assert _rowrel(got_s, ora_s) < TOL_ORACLE["wkv"]
    jr = lambda a: jnp.asarray(a.numpy()).transpose(0, 2, 1, 3)   # noqa: E731
    rora_y, _ = rref.rwkv6_wkv_ref(jr(r), jr(k), jr(v), jr(logw), _j(u), _j(zero))
    assert _rowrel(got_y, np.asarray(rora_y).transpose(0, 2, 1, 3)) < TOL_ORACLE["wkv"]
    pal_y, pal_s = rops.rwkv6_wkv(_j(r), _j(k), _j(v), _j(logw), _j(u), _j(zero))
    assert _rowrel(got_y, pal_y) < TOL_PALLAS and _rowrel(got_s, pal_s) < TOL_PALLAS
    plain_y, plain_s = wkv.wkv_chunked_plain(r, k, v, logw, u, s0)
    assert _rowrel(got_y, plain_y) < TOL_PALLAS and _rowrel(got_s, plain_s) < TOL_PALLAS


# 64 is the kernel's chunk, 32 its chunk at N = P = 128, 128 the other size timed
@pytest.mark.parametrize("lc", [32, 64, 128])
@pytest.mark.parametrize("state", [True, False])
@pytest.mark.parametrize("t", TS)
def test_ssd_chunk_model_matches_reference(t, state, lc):
    x, bm, cm, dt, a_log, s0 = _ssd_case(t, state)
    b, _, h, p = x.shape
    n = bm.shape[-1]
    zero = torch.zeros(b, h, n, p) if s0 is None else s0
    got_y, got_s = model_ssd(x, bm, cm, dt, a_log, s0, lc)
    ora_y, ora_s = ref.mamba2_ssd_ref(x.transpose(1, 2), bm, cm, dt.transpose(1, 2), a_log, zero)
    assert _rowrel(got_y, ora_y.transpose(1, 2)) < TOL_ORACLE["ssd"]
    assert _rowrel(got_s, ora_s) < TOL_ORACLE["ssd"]
    rora_y, _ = rref.mamba2_ssd_ref(_j(x).transpose(0, 2, 1, 3), _j(bm), _j(cm),
                                    _j(dt).transpose(0, 2, 1), _j(a_log), _j(zero))
    assert _rowrel(got_y, np.asarray(rora_y).transpose(0, 2, 1, 3)) < TOL_ORACLE["ssd"]
    pal_y, pal_s = rops.mamba2_ssd(_j(x), _j(bm), _j(cm), _j(dt), _j(a_log), _j(zero))
    assert _rowrel(got_y, pal_y) < TOL_PALLAS and _rowrel(got_s, pal_s) < TOL_PALLAS
    plain_y, plain_s = ssd.ssd_plain(x, bm, cm, dt, a_log, s0)
    assert _rowrel(got_y, plain_y) < TOL_PALLAS and _rowrel(got_s, plain_s) < TOL_PALLAS


@pytest.mark.parametrize("state", [True, False])
@pytest.mark.parametrize("t", TS)
def test_ssd_chunk_model_needs_three_terms(t, state):
    """Two-term operands (hi + lo) read farther from the per-token oracle
    than the kernel's three: the third term is what the limits rest on."""
    x, bm, cm, dt, a_log, s0 = _ssd_case(t, state)
    b, _, h, p = x.shape
    n = bm.shape[-1]
    zero = torch.zeros(b, h, n, p) if s0 is None else s0
    ora_y, ora_s = ref.mamba2_ssd_ref(x.transpose(1, 2), bm, cm, dt.transpose(1, 2), a_log, zero)
    err = {}
    for terms in (2, 3):
        got_y, got_s = model_ssd(x, bm, cm, dt, a_log, s0, ssd.KERNEL_CHUNK, terms)
        err[terms] = max(_rowrel(got_y, ora_y.transpose(1, 2)), _rowrel(got_s, ora_s))
    assert err[2] > err[3], err
