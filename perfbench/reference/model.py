"""The served models in plain PyTorch: fp32, TF32 off, no kernel, no cache.

A decoder layer, as the configuration files state it (perfbench/configs):

    h = x + Attn(RMSNorm(x) * g1)         GQA, RoPE (half split) on q and k,
                                          causal softmax(q k^T / sqrt(Dh)) v
    x' = h + FFN(RMSNorm(h) * g2)         SwiGLU: (silu(h Wg) * (h Wu)) Wd

and logits = (RMSNorm(x_L) * gf) lm_head^T. The FFN is the caller's to
choose (`ffn`, one family's; perfbench/families): `swiglu` above, or `moe`,
the routed mixture plus the shared expert, ungated: the router's softmax
over the experts, the top-k of it renormalised to sum to 1, and a capacity
dispatch. Tokens go through the experts in groups; a group of T tokens gives
each expert max(int(T k cf / E), k) slots, taken by the group's (token, k)
units in token order, and a unit that finds its expert's slots full is
dropped. Which tokens form a group is the caller's to say (`flat_groups`):
it is the served run's schedule, not arithmetic.

`quant="fp8"` is the control: every product's inputs rounded to float8 e4m3
(weights per output column, activations per row, keys and values per row),
computed in fp32.

The whole of one layer runs for every token of every sequence before the
next layer starts, so only one layer's weights are upcast at a time.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def exact_fp32() -> None:
    """fp32 products in fp32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Layerwise:
    """One precision's products and weights."""

    def __init__(self, w: dict, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant must be None or 'fp8': {quant!r}")
        self.w, self.quant = w, quant

    def weight(self, name: str, *index) -> torch.Tensor:
        t = self.w[name]
        for i in index:
            t = t[i]
        t = t.float()
        return _fp8(t, dim=-2) if self.quant else t

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, dim=-1) if self.quant else x

    def mm(self, x, wt):
        """x (..., n) @ wt (n, m), wt already through `weight`."""
        return self.act(x) @ wt


def rmsnorm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g.float()


def rope(x, pos, theta):
    """x (T, heads, Dh), pos (T,): rotate the two halves of each head."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = (pos.double()[:, None] * inv).float()
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v):
    """q (S, H, Dh), k/v (S, KV, Dh) of one sequence -> (S, H, Dh)."""
    s, h, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("shd,thd->hst", q, k) * dh ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hst,thd->shd", probs, v)


def capacity(tokens: int, cfg: dict) -> int:
    k, e = cfg["num_experts_per_tok"], cfg["num_experts"]
    return max(int(tokens * k * cfg["capacity_factor"] / e), k)


def moe(P: Layerwise, l: int, x, cfg: dict, groups: list[torch.Tensor]):
    """x (T, D) -> (T, D): routed experts over `groups` (each a LongTensor of
    token rows in dispatch order; together every row once) + shared expert."""
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    dev = x.device
    probs = torch.softmax(P.mm(x, P.weight("router", l)), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)

    order = torch.cat(groups)                                   # rows in dispatch order
    gid = torch.cat([torch.full((len(g),), i, dtype=torch.long, device=dev)
                     for i, g in enumerate(groups)])
    cap = torch.tensor([capacity(len(g), cfg) for g in groups], device=dev)
    unit_row = order.repeat_interleave(k)
    unit_e = idx[order].reshape(-1)
    unit_g = gid.repeat_interleave(k)
    unit_w = gate[order].reshape(-1)
    # a unit's rank among its group's units of the same expert, in order
    key = unit_g * e + unit_e
    skey, perm = torch.sort(key, stable=True)
    n = skey.numel()
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = skey[1:] != skey[:-1]
    start = torch.cummax(torch.where(new, torch.arange(n, device=dev), 0), 0).values
    rank = torch.empty(n, dtype=torch.long, device=dev)
    rank[perm] = torch.arange(n, device=dev) - start
    keep = rank < cap[unit_g]

    out = torch.zeros_like(x)
    for ex in range(e):
        sel = keep & (unit_e == ex)
        rows = unit_row[sel]
        if rows.numel() == 0:
            continue
        h = x[rows]
        y = (torch.nn.functional.silu(P.mm(h, P.weight("e_gate", l, ex)))
             * P.mm(h, P.weight("e_up", l, ex)))
        out.index_add_(0, rows, P.mm(y, P.weight("e_down", l, ex)) * unit_w[sel, None])
    return out + swiglu(P, l, x, ("s_gate", "s_up", "s_down"))


def swiglu(P: Layerwise, l: int, x, names=("w_gate", "w_up", "w_down"), rows=16384):
    g, u, d = (P.weight(n, l) for n in names)
    out = torch.empty_like(x)
    for i in range(0, x.shape[0], rows):
        h = x[i:i + rows]
        out[i:i + rows] = P.mm(torch.nn.functional.silu(P.mm(h, g)) * P.mm(h, u), d)
    return out


def flat_groups(groups: list[list[tuple[int, torch.Tensor]]], lens: list[int],
                device) -> list[torch.Tensor]:
    """Dispatch groups, each [(sequence, positions), ...] in dispatch order,
    as rows of the sequences laid end to end (lengths `lens`), for `moe`.
    Every position of every sequence has to be in one group."""
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)
    flat = [torch.cat([offs[i] + p.to(device) for i, p in g]) for g in groups]
    seen = torch.zeros(offs[-1], dtype=torch.long, device=device)
    seen.index_add_(0, torch.cat(flat), torch.ones_like(torch.cat(flat)))
    if not bool((seen == 1).all()):
        raise ValueError("moe groups must hold every position exactly once")
    return flat


def logits(w: dict, cfg: dict, seqs: list[torch.Tensor], rows: list[torch.Tensor],
           ffn=swiglu, quant: str | None = None) -> list[torch.Tensor]:
    """The logits (len(rows[i]), V) at positions rows[i] of each sequence
    seqs[i] (token ids fed, (S_i,) long), fp32. `ffn(P, l, h)` is a layer's
    FFN on the normed rows h of all sequences laid end to end."""
    exact_fp32()
    P = Layerwise(w, quant)
    dev = w["embed"].device
    L, eps = cfg["num_hidden_layers"], cfg["rms_norm_eps"]
    H, KV, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    lens = [int(s.numel()) for s in seqs]
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)
    x = w["embed"][torch.cat(seqs).to(dev)].float()
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    for l in range(L):
        h = rmsnorm(x, w["norm1"][l], eps)
        q = rope(P.mm(h, P.weight("wq", l)).view(-1, H, Dh), pos, cfg["rope_theta"])
        kk = rope(P.mm(h, P.weight("wk", l)).view(-1, KV, Dh), pos, cfg["rope_theta"])
        vv = P.mm(h, P.weight("wv", l)).view(-1, KV, Dh)
        kk, vv = P.act(kk), P.act(vv)
        o = torch.empty_like(q)
        for a, b in zip(offs[:-1], offs[1:]):
            o[a:b] = causal_attention(q[a:b], kk[a:b], vv[a:b])
        del q, kk, vv
        x = x + P.mm(o.view(-1, H * Dh), P.weight("wo", l))
        del o
        h = rmsnorm(x, w["norm2"][l], eps)
        x = x + ffn(P, l, h)
        del h
    head = P.weight("lm_head").T if not P.quant else _fp8(w["lm_head"].float(), dim=-1).T
    out = []
    for i, r in enumerate(rows):
        xs = rmsnorm(x[offs[i] + r.to(dev)], w["final_norm"], eps)
        out.append(P.mm(xs, head))
    return out
