"""Plain torch fp32 oracles for the kernels.

Deliberately different algorithms from the kernels: every attention oracle
casts to fp32 first and materialises the full score matrix, and the two
recurrence oracles step one token at a time, in the heads-major layouts of
the TPU kernels (src/repro/kernels/ref.py), so the tests can hold the port's
kernels and plain versions against them and against the reference's jnp
oracles on the same inputs.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _softmax_out(scores, v, dtype):
    return torch.einsum("...t,...td->...d", torch.softmax(scores, dim=-1), v).to(dtype)


def flash_attention_ref(q, k, v, causal: bool = True):
    """q: (B, H, S, D), k/v: (B, KV, S, D) -> (B, H, S, D)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, kvh, h // kvh, s, d).float()
    scores = torch.einsum("bqgsd,bqtd->bqgst", qg, k.float()) * (d ** -0.5)
    if causal:
        mask = torch.tril(torch.ones(s, s, dtype=torch.bool, device=q.device))
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bqgst,bqtd->bqgsd", p, v.float())
    return o.reshape(b, h, s, d).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, pos):
    """q: (B, KV, G, D), caches: (B, KV, S, D), pos: (B,) -> (B, KV, G, D)."""
    d = q.shape[-1]
    s = k_cache.shape[2]
    scores = torch.einsum("bqgd,bqtd->bqgt", q.float(), k_cache.float()) * (d ** -0.5)
    mask = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    return _softmax_out(scores, v_cache.float()[:, :, None], q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, tables, lengths, k_new, v_new):
    """q: (B, KV, G, D), pages: (NBp, KV, bs, D), tables: (B, NB) int32,
    lengths: (B,), k_new/v_new: (B, KV, 1, D) -> (B, KV, G, D).

    Densify every table page, write the new token at its `lengths` slot,
    one full masked softmax (kpos <= lengths). Needs NB * bs > max(lengths)."""
    b, kvh, _, d = q.shape
    nb, bs = tables.shape[1], k_pages.shape[2]
    rows = torch.arange(b, device=q.device)

    def densify(pages, new):
        got = pages[tables.long()].float()             # (B, NB, KV, bs, D)
        cache = got.transpose(1, 2).reshape(b, kvh, nb * bs, d).clone()
        cache[rows, :, lengths.long()] = new[:, :, 0].float()
        return cache

    kc, vc = densify(k_pages, k_new), densify(v_pages, v_new)
    scores = torch.einsum("bqgd,bqtd->bqgt", q.float(), kc) * (d ** -0.5)
    mask = torch.arange(nb * bs, device=q.device)[None, :] <= lengths[:, None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    return _softmax_out(scores, vc[:, :, None], q.dtype)


def paged_prefill_attention_ref(q, k_pages, v_pages, table, ctx: int,
                                k_self, v_self, group: int = 1):
    """q: (KV, C*G, D) token-major (row r is token r // G), pages
    (NBp, KV, bs, D), table: (NB,) int32, ctx: cached tokens, k_self/v_self:
    (KV, C, D) -> (KV, C*G, D)."""
    kvh, cg, d = q.shape
    c = k_self.shape[1]
    nb, bs = table.shape[0], k_pages.shape[2]

    def densify(pages):
        got = pages[table.long()].float()              # (NB, KV, bs, D)
        return got.transpose(0, 1).reshape(kvh, nb * bs, d)

    kc = torch.cat([densify(k_pages), k_self.float()], dim=1)
    vc = torch.cat([densify(v_pages), v_self.float()], dim=1)
    scores = torch.einsum("qrd,qtd->qrt", q.float(), kc) * (d ** -0.5)
    col = torch.arange(nb * bs + c, device=q.device)[None, :]
    row_tok = torch.arange(cg, device=q.device)[:, None] // group
    visible = torch.where(col < nb * bs, col < ctx, col - nb * bs <= row_tok)
    scores = torch.where(visible[None], scores, NEG_INF)
    return _softmax_out(scores, vc[:, None], q.dtype)


def rwkv6_wkv_ref(r, k, v, logw, u, state0):
    """Per-token WKV6 recurrence. r/k/v/logw (B, H, T, N), u (H, N), state0
    (B, H, N, N) -> (y (B, H, T, N) fp32, final state)."""
    rf, kf, vf, lw = (a.float() for a in (r, k, v, logw))
    s = state0.float()
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[2]):
        kv = torch.einsum("bhn,bhm->bhnm", kf[:, :, t], vf[:, :, t])
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, :, t], s + uf * kv))
        s = s * torch.exp(lw[:, :, t])[..., None] + kv
    return torch.stack(ys, dim=2), s


def mamba2_ssd_ref(x, b_in, c_in, dt, a_log, state0, clamp: float = 1.0):
    """Per-token SSD recurrence. x (B, H, T, P), b_in/c_in (B, T, N), dt
    (B, H, T), a_log (H,), state0 (B, H, N, P) -> (y (B, H, T, P) fp32,
    final state)."""
    xf, bf, cf, dtf = x.float(), b_in.float(), c_in.float(), dt.float()
    a = -torch.exp(a_log.float())                       # (H,)
    s = state0.float()
    ys = []
    for t in range(x.shape[2]):
        la = torch.clamp(a * dtf[:, :, t], -clamp, 0.0)   # (B, H)
        upd = torch.einsum("bn,bhp->bhnp", bf[:, t], xf[:, :, t] * dtf[:, :, t, None])
        s = s * torch.exp(la)[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], s))
    return torch.stack(ys, dim=2), s
