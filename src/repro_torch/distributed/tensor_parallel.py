"""The two vocab-sharded operations of the sharded train step, written by
hand: the embedding lookup and the cross-entropy over vocab-sharded logits.

The reference shards the embedding and LM-head rows on "model"
(sharding.py) and leaves the gather and the loss to XLA's partitioner.
DTensor has no working rule for either: `F.embedding` over a row-sharded
table fails when its output meets the next product (a mask-shape error in
its masked-partial placement), and after an explicit redistribute it fails
in backward (no redistribution from a sum-partial to a masked-partial).
Replicating the tables would be another sharding than the reference's, so
both are written here over the local shards, Megatron style:

  embed  each rank looks up the tokens that fall in its rows (zeros for the
         others) and the rows are summed over the vocab-sharded mesh dim;
  loss   the max, the sum of exponentials and the gold logit (the
         reference's one-hot masked sum) are reduced over that dim, so each
         rank holds every token's log-sum-exp and gold logit.

Attention needs no collective: it is independent per sequence and per kv
head group. `local_attention` places q, k and v alike (the batch over the
data axes, heads over "model" where the kv heads divide evenly, which keeps
each query head beside its kv head) and runs the blocked attention on each
rank's shards. DTensor's own einsum rule cannot flatten a batch dim with a
sharded head dim behind it (torch 2.11 raises at the attention product once
the kv projections are sharded).

The MoE routing (top-k, the stable argsort that ranks units within their
expert, the scatter into capacity slots) has no DTensor rules either, and a
dispatch group may span the data shards. `replicated_region` runs such a
function on whole tensors: its inputs are redistributed to Replicate (an
all-gather of the batch over the data axes and of the expert banks over
"model"), every rank computes the whole function, and the output returns
to the input's placements.

The sums pass their gradient through unchanged (each rank's partial term
gets the whole gradient of the sum); the max is a constant of the
log-sum-exp and carries none. DTensor's own autograd carries everything
outside these two functions.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate


class _SumOver(torch.autograd.Function):
    """All-reduce sum over a process group; the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_dim(t: DTensor, dim: int) -> int | None:
    """The mesh dim that shards tensor dim `dim` of t, or None."""
    dims = [i for i, p in enumerate(t.placements) if p.is_shard(dim)]
    if len(dims) > 1:
        raise ValueError(f"vocab dim sharded over mesh dims {dims}: one at most")
    return dims[0] if dims else None


def _offset(t: DTensor, mesh_dim: int | None, dim: int) -> tuple[int, int]:
    """(first row, rows) of this rank's chunk of tensor dim `dim`."""
    full = t.shape[dim]
    if mesh_dim is None:
        return 0, full
    n = t.device_mesh.size(mesh_dim)
    chunk = -(-full // n)
    start = t.device_mesh.get_local_rank(mesh_dim) * chunk
    return start, max(0, min(chunk, full - start))


def _as_dtensor(x, mesh) -> DTensor:
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _batch_placements(placements, ndim_keep: int) -> list:
    """A token tensor's placements: its own shards of dims < ndim_keep,
    Replicate elsewhere."""
    return [p if p.is_shard() and p.dim < ndim_keep else Replicate() for p in placements]


def vocab_parallel_embed(table: DTensor, tokens):
    """table (V, D) a DTensor, its rows sharded over at most one mesh dim;
    tokens (B, S) -> (B, S, D), placed as the tokens are (and replicated
    over the table's vocab dim)."""
    mesh = table.device_mesh
    tok = _as_dtensor(tokens, mesh)
    vdim = _vocab_dim(table, 0)
    out_pl = _batch_placements(tok.placements, tok.ndim)
    tok = tok.redistribute(mesh, out_pl)
    # the local rows' gradient: this rank's shard on the vocab dim, a partial
    # sum on a dim that shards the tokens, replicated elsewhere
    grad_pl = [p if i == vdim else (Partial() if out_pl[i].is_shard() else Replicate())
               for i, p in enumerate(table.placements)]
    local = table.to_local(grad_placements=grad_pl)
    start, rows = _offset(table, vdim, 0)
    idx = tok.to_local().long() - start
    valid = (idx >= 0) & (idx < rows)
    out = F.embedding(idx.clamp(0, max(rows - 1, 0)), local) * valid[..., None].to(local.dtype)
    if vdim is not None:
        out = _SumOver.apply(out, mesh.get_group(vdim))
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def vocab_parallel_cross_entropy(logits: DTensor, labels):
    """Mean next-token cross-entropy of logits (B, S, V), a DTensor whose
    vocab dim may be sharded over one mesh dim, against labels (B, S), in
    fp32: log-sum-exp minus the gold logit, averaged over every token.
    Returns a replicated scalar DTensor."""
    mesh = logits.device_mesh
    v_axis = logits.ndim - 1
    pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    logits = logits.redistribute(mesh, pl)
    vdim = _vocab_dim(logits, v_axis)
    tok_pl = _batch_placements(pl, v_axis)
    lab = _as_dtensor(labels, mesh).redistribute(mesh, tok_pl).to_local()
    lf = logits.to_local().float()
    start, rows = _offset(logits, vdim, v_axis)
    group = None if vdim is None else mesh.get_group(vdim)

    m = lf.detach().amax(dim=-1)
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    sumexp = torch.exp(lf - m[..., None]).sum(dim=-1)
    onehot = (lab.long() - start)[..., None] == torch.arange(rows, device=lf.device)
    gold = torch.where(onehot, lf, 0.0).sum(dim=-1)
    if group is not None:
        sumexp = _SumOver.apply(sumexp, group)
        gold = _SumOver.apply(gold, group)
    ce = torch.log(sumexp) + m - gold
    ce = DTensor.from_local(ce, mesh, tok_pl, run_check=False).mean()
    return ce.redistribute(mesh, [Replicate()] * mesh.ndim)


def replicated_region(fn, p: dict, x: DTensor, *args):
    """fn(p, x, *args) on whole tensors: p's DTensor leaves and x
    redistributed to Replicate; a result of x's shape is sharded as x is,
    any other (a scalar) stays replicated."""
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def whole(t):
        if isinstance(t, dict):
            return {k: whole(v) for k, v in t.items()}
        return t.redistribute(mesh, rep).to_local() if isinstance(t, DTensor) else t

    out = fn(whole(p), whole(x), *args)
    out = DTensor.from_local(out, mesh, rep, run_check=False)
    if out.shape != x.shape:
        return out
    # x's shards (a partial sum of x is summed by now)
    return out.redistribute(mesh, [Replicate() if q.is_partial() else q for q in x.placements])


def local_attention(fn, q: DTensor, k, v, *args):
    """fn(q, k, v, *args) -> (B, S, H, D) on each rank's shards. q (B, S,
    H, D) and k, v (B, S, KV, D) take one placement: per mesh dim the
    batch shard of q, or its head shard where KV divides by the mesh dim's
    size (query head h's kv head h // G stays on its rank), else
    Replicate. The result keeps that placement."""
    mesh = q.device_mesh
    kv = k.shape[2]
    pl = [p if p.is_shard(0) or (p.is_shard(2) and kv % mesh.size(i) == 0) else Replicate()
          for i, p in enumerate(q.placements)]
    q, k, v = (_as_dtensor(t, mesh).redistribute(mesh, pl) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(), *args)
    return DTensor.from_local(out, mesh, pl, run_check=False)
