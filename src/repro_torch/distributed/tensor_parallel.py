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
dispatch group may span the data shards. Without a sequence-parallel carry
(ExecConfig.carry_spec None) `replicated_region` runs such a function on
whole tensors: its inputs are redistributed to Replicate (an all-gather of
the batch over the data axes and of the expert banks over "model"), every
rank computes the whole function, and the output returns to the input's
placements. With a carry, `expert_parallel_region` is the reference's
anchored dispatch written over local shards: each rank routes its own
groups, the dispatch buffers are exchanged expert-major over the
expert-parallel axes (one all-to-all each way, `_AllToAll`), the experts
run on each rank's expert and hidden shards, and the partial sums over
"model" are reduce-scattered onto the carry. `batch_sum_region` runs the
load-balancing loss's sums on each rank's tokens and adds them up.

`spec_placements` maps a PartitionSpec-like tuple (the reference's
carry_spec, the sharding rules' specs) to DTensor placements.

The chunked recurrences (WKV, SSD) are independent per sequence and per
head too, and a chunk loop of small products would pay DTensor's dispatch
on every one: `per_head_region` runs such a function on each rank's shards
(the batch where the data axes shard it, the heads where their count
divides the mesh dim, else whole) and places its results alike.

A decode cache sharded on its sequence dim (sharding.cache_pspecs) takes
the step's new K/V by `write_slots`: each rank writes the rows that fall in
its own slice of the sequence, in place, as XLA's partitioner lowers the
reference's dynamic-update-slice; DTensor refuses an in-place index_put_
on a sharded dim. `local_decode_attention` attends over such a cache
flash-decoding style: the query (one token) is gathered whole, each rank
scores its own keys, and the softmax's max and sum and the weighted values
are reduced over the mesh dims that shard the sequence. No serving path
holds a sharded cache: the dry-run's decode cells (launch/dryrun.py) are
these two functions' only caller, and tests/test_torch_sharded_decode.py
holds them to the plain decode.

The sums pass their gradient through unchanged (each rank's partial term
gets the whole gradient of the sum); the max is a constant of the
log-sum-exp and carries none; the all-to-all's gradient takes the reverse
exchange. Everything else is DTensor's own autograd: a local shard taken
with `to_local(grad_placements=...)` hands back a gradient that is partial
over the mesh dims where ranks computed different terms of it, and
DTensor reduces it (a reduce-scatter where the previous redistribute had
gathered over that dim).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset


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


class _AllToAll(torch.autograd.Function):
    """x (n, ...) -> (n, ...) over a process group of n ranks: block j goes
    to rank j, block r of the result came from rank r. The gradient takes
    the way back, which is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    return funcol.wait_tensor(funcol.all_to_all_single(x.contiguous(), None, None, group))


def spec_placements(spec: tuple, axis_names) -> list:
    """A PartitionSpec-like tuple, one entry per tensor dim (None, an axis
    name or a tuple of names), -> DTensor placements over a mesh whose dims
    are `axis_names`: per mesh dim, Shard(i) for the tensor dim i that names
    it, else Replicate()."""
    out = []
    for axis in axis_names:
        dims = [i for i, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def placed(t: DTensor, placements) -> DTensor:
    """t redistributed to `placements`; t itself where it is so placed
    already, so that a gradient arriving as a partial sum reaches the
    previous redistribute as one (a reduce-scatter there, not an all-reduce
    here)."""
    placements = list(placements)
    if list(t.placements) == placements:
        return t
    return t.redistribute(t.device_mesh, placements)


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


def _from_local(t, mesh, placements, shape) -> DTensor:
    """A DTensor of global `shape` from this rank's shard t: the shape is
    given, as a batch may split unevenly (3 over 2 ranks); the stride lays
    the dims out in t's own order."""
    stride, step = [0] * t.ndim, 1
    for i in sorted(range(t.ndim), key=lambda i: (t.stride(i), t.shape[i])):
        stride[i], step = step, step * shape[i]
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


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


def _mesh_dims(mesh, axes) -> list[int]:
    """The mesh dims of `axes`: None, an axis name or a tuple of names."""
    if axes is None:
        return []
    return [mesh.mesh_dim_names.index(a) for a in (axes if isinstance(axes, tuple) else (axes,))]


def _exchange(t, mesh, dims: list[int], back: bool = False):
    """The expert-major exchange of a dispatch buffer over the mesh dims
    `dims`, one all-to-all a dim. t (G, E, ...), this rank's groups for
    every expert -> (n G, E / n, ...), every group of the exchange for this
    rank's E / n experts (n the dims' sizes' product; the experts chunked
    as a DTensor's Shard(0) over those dims chunks them). back=True is the
    way back."""
    for i in (reversed(dims) if back else dims):
        n, group = mesh.size(i), mesh.get_group(i)
        if back:
            rest = t.shape[1:]
            t = _AllToAll.apply(t.reshape(n, -1, *rest), group)         # (n, G, E/n, ...)
            t = t.transpose(0, 1).reshape(t.shape[1], n * rest[0], *rest[1:])
        else:
            g, e = t.shape[:2]
            t = t.reshape(g, n, e // n, *t.shape[2:]).transpose(0, 1)    # (n, G, E/n, ...)
            t = _AllToAll.apply(t, group).reshape(n * g, e // n, *t.shape[3:])
    return t


def expert_parallel_region(body, p: dict, x: DTensor, exec_cfg, num_experts: int):
    """The MoE over x (B, S, D) under a sequence-parallel carry
    (exec_cfg.carry_spec, e.g. (("data",), "model", None)), returned placed
    as the carry. body(p, xg, experts) is the MoE over groups xg (G, Tg, D)
    of local tensors; it calls experts(ein, fn) to run the expert products
    fn on its dispatch buffer ein (G, E, C, D).

    A group is `moe_group_size` contiguous tokens. The groups stay on the
    data axes when their count is a multiple of 32 (the reference's rule)
    and they fall whole into the batch shards (true of every production
    cell); otherwise every rank holds them all. Each rank routes its own
    groups. With exec_cfg.ep_axes the buffer goes expert-major over those
    axes (one all-to-all a mesh dim each way; a buffer replicated over them
    is first split by capacity slots, and the slots gathered back after),
    so each rank runs its E / ep experts' slots of every group of the
    exchange on its banks (E / ep, D, F / tp), the FFN hidden dim on
    "model"; without, the same with no exchange. The expert products and
    the shared expert are partial sums over "model": the combine, linear in
    them, takes them as they are, and the sum is reduce-scattered onto the
    carry (tokens, not capacity slots, cross the wire).

    Gradients: x's local copy gets a partial sum over "model", which the
    norm's gather that x came through reduce-scatters onto the carry; an
    expert bank's is partial over the group axes that do not shard its
    experts, the shared expert's over the group axes, the router's over
    the group axes and "model"."""
    mesh = x.device_mesh
    nd = mesh.ndim
    carry = spec_placements(exec_cfg.carry_spec, mesh.mesh_dim_names)
    mdim = mesh.mesh_dim_names.index(exec_cfg.carry_spec[1])
    dp = _mesh_dims(mesh, exec_cfg.carry_spec[0])
    ep = _mesh_dims(mesh, exec_cfg.ep_axes)
    n_dp = math.prod(mesh.size(i) for i in dp)
    n_ep = math.prod(mesh.size(i) for i in ep)
    if any(i not in dp for i in ep) or num_experts % n_ep:
        raise ValueError(f"ep_axes {exec_cfg.ep_axes} must be data axes of the carry "
                         f"{exec_cfg.carry_spec} whose size divides {num_experts} experts")
    b, s, d = x.shape
    tg = min(exec_cfg.moe_group_size, b * s)
    assert (b * s) % tg == 0, f"tokens {b * s} not divisible by group {tg}"
    g = b * s // tg
    gdims = dp if g % 32 == 0 and b % n_dp == 0 and (b // n_dp * s) % tg == 0 else []
    rep = [Replicate()] * nd

    def local(t, target, partial_dims):
        grad = [Partial() if i in partial_dims else q for i, q in enumerate(target)]
        return placed(_as_dtensor(t, mesh), target).to_local(grad_placements=grad)

    def bank(hidden):
        return [Shard(0) if i in ep else Shard(hidden) if i == mdim else Replicate()
                for i in range(nd)]

    free = [i for i in gdims if i not in ep]
    pl = {"router": local(p["router"], rep, gdims + [mdim]),
          "w_gate": local(p["w_gate"], bank(2), free),
          "w_up": local(p["w_up"], bank(2), free),
          "w_down": local(p["w_down"], bank(1), free)}
    if "shared" in p:
        sh = p["shared"]
        col = [Shard(1) if i == mdim else Replicate() for i in range(nd)]
        row = [Shard(0) if i == mdim else Replicate() for i in range(nd)]
        pl["shared"] = {"w_gate": local(sh["w_gate"], col, gdims),
                        "w_up": local(sh["w_up"], col, gdims),
                        "w_down": local(sh["w_down"], row, gdims)}
    xpl = [Shard(0) if i in gdims else Replicate() for i in range(nd)]
    xl = local(x, xpl, [mdim])
    split = [Shard(2) if i in ep else Replicate() for i in range(nd)]

    def experts(ein, fn):
        if not ep:
            return fn(ein)
        cap = ein.shape[2]
        pad = -cap % n_ep
        if not gdims:      # replicated over the EP axes: each rank sends its slots
            ein = DTensor.from_local(F.pad(ein, (0, 0, 0, pad)), mesh, rep, run_check=False)
            ein = ein.redistribute(mesh, split).to_local()
        h = _exchange(fn(_exchange(ein, mesh, ep)), mesh, ep, back=True)
        if not gdims:
            h = _from_local(h, mesh, split, (*h.shape[:2], cap + pad, h.shape[3]))
            h = h.redistribute(mesh, rep).to_local()[:, :, :cap]
        return h

    out = body(pl, xl.reshape(-1, tg, d), experts)        # partial over "model"
    opl = [Shard(0) if i in gdims else Partial() if i == mdim else Replicate()
           for i in range(nd)]
    return placed(_from_local(out.reshape(xl.shape), mesh, opl, x.shape), carry)


def batch_sum_region(fn, p: dict, x: DTensor, *args) -> tuple:
    """fn(p, x, *args) -> a tuple of sums over x's tokens, run on this
    rank's tokens (x placed by its batch shards, p's leaves replicated) and
    added up over the mesh dims that shard the batch (forward all-reduce;
    the gradient passes through: each rank's term gets the whole sum's).
    Returns replicated DTensors; p's gradients are partial over those
    dims."""
    mesh = x.device_mesh
    xpl = _batch_placements(x.placements, 1)
    dims = [i for i, q in enumerate(xpl) if q.is_shard()]
    rep = [Replicate()] * mesh.ndim
    grad = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]

    def local(t):
        if isinstance(t, dict):
            return {k: local(v) for k, v in t.items()}
        return placed(_as_dtensor(t, mesh), rep).to_local(grad_placements=grad)

    sums = []
    for o in fn(local(p), placed(x, xpl).to_local(), *args):
        for i in dims:
            o = _SumOver.apply(o, mesh.get_group(i))
        sums.append(DTensor.from_local(o, mesh, rep, run_check=False))
    return tuple(sums)


def local_attention(fn, q: DTensor, k, v, *args):
    """fn(q, k, v, *args) -> (B, S, H, D) on each rank's shards. q (B, S,
    H, D) and k, v (B, S, KV, D) take one placement: per mesh dim the
    batch shard of q, or its head shard where the KV heads split evenly
    over it (query head h's kv head h // G stays on its rank), else the
    sequences split over it where they divide evenly (attention is
    independent per sequence: no rank computes another's heads), else
    Replicate. The result keeps that placement."""
    mesh = q.device_mesh
    b, kv = q.shape[0], k.shape[2]
    pl, bsplit, hsplit = [], 1, 1
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p.is_shard(0):
            pl.append(p)
            bsplit *= n
        elif p.is_shard(2) and kv % (hsplit * n) == 0:
            pl.append(p)
            hsplit *= n
        elif b % (bsplit * n) == 0:
            pl.append(Shard(0))
            bsplit *= n
        else:
            pl.append(Replicate())
    q, k, v = (_as_dtensor(t, mesh).redistribute(mesh, pl) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(), *args)
    return _from_local(out, mesh, pl, q.shape)


def write_slots(cache: DTensor, new, pos) -> None:
    """cache (B, KV, S, D), a DTensor, <- new (B, KV, K, D) at per-sequence
    slots pos[b] .. pos[b] + K - 1, in place, on each rank's shard: new and
    pos are placed as the cache's batch and head shards (replicated over the
    sequence), and a rank keeps its old rows where a slot falls outside its
    slice of S. Shapes stay fixed, so no value is read on the host."""
    mesh = cache.device_mesh
    pl = [Replicate() if p.is_shard(2) else p for p in cache.placements]
    new_l = _as_dtensor(new, mesh).redistribute(mesh, pl).to_local()
    pos_l = _as_dtensor(pos, mesh).redistribute(mesh, _batch_placements(pl, 1)).to_local()
    local = cache.to_local()
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cache.placements)
    b, _, kk, _ = new_l.shape
    start = pos_l.long()[:, None] - offset[2]                     # (B, 1), local
    slots = (start + torch.arange(kk, device=local.device)[None, :]).clamp(
        0, max(local.shape[2] - 1, 0))
    # a slot clamped onto the shard's edge may be one that another token
    # writes: every write to a slot carries the token that belongs there
    # (or the old row), so duplicate indices agree
    tok = slots - start
    inside = (tok >= 0) & (tok < kk)
    rows = torch.arange(b, device=local.device)[:, None]
    vals = new_l.permute(0, 2, 1, 3)[rows, tok.clamp(0, kk - 1)]  # (B, K, KV, D)
    local[rows, :, slots] = torch.where(inside[..., None, None], vals, local[rows, :, slots])


def local_decode_attention(q, k_cache: DTensor, v_cache: DTensor, pos, neg_inf: float):
    """One query token q (B, 1, H, D) against caches (B, KV, S, D) placed as
    DTensors (batch and sequence shards), mask kpos <= pos -> (B, 1, H, D),
    placed as the caches' batch. The plain decode's math (fp32 scores and
    softmax, probabilities cast to q's dtype before the value product), with
    the softmax's max and sum and the value product reduced over the
    sequence shards."""
    mesh = k_cache.device_mesh
    pl = _batch_placements(k_cache.placements, 1)
    groups = [mesh.get_group(i) for i, p in enumerate(k_cache.placements) if p.is_shard(2)]
    _, offset = compute_local_shape_and_global_offset(k_cache.shape, mesh, k_cache.placements)
    start = offset[2]
    out_shape = q.shape
    q = _as_dtensor(q, mesh).redistribute(mesh, pl).to_local()
    pos = _as_dtensor(pos, mesh).redistribute(mesh, pl).to_local()
    k, v = k_cache.to_local(), v_cache.to_local()
    b, kvh, s_local, d = k.shape
    h = q.shape[2]
    qh = q[:, 0].reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bqgd,bqtd->bqgt", qh, k).float() * (d ** -0.5)
    kpos = start + torch.arange(s_local, device=k.device)
    scores = torch.where((kpos[None, :] <= pos[:, None])[:, None, None], scores, neg_inf)
    m = scores.amax(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    p = torch.exp(scores - m)
    total = p.sum(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(total, group=g)
    out = torch.einsum("bqgt,bqtd->bqgd", (p / total).to(q.dtype), v)
    for g in groups:
        dist.all_reduce(out, group=g)
    return _from_local(out.reshape(b, 1, h, d), mesh, pl, out_shape)


def per_head_region(fn, like: DTensor, heads: int, args, dims, out_dims):
    """fn(*args) on each rank's shards, for a function that is independent
    per sequence and per head. Per mesh dim the plan follows `like` (B,
    ...): its batch shard where it has one, else the heads where `heads`
    divides the mesh dim's size, else nothing. dims[i] is (batch dim, head
    dim) of args[i] (None where it has none; an arg that is not a tensor
    passes as it is); out_dims the same of fn's results, which return as
    DTensors so placed. An arg replicated over a mesh dim that splits the
    work (a_log over the batch shards, B over the heads) gets only this
    rank's part of its gradient: it leaves as Partial there, and DTensor's
    autograd sums it."""
    mesh = like.device_mesh
    plan, split = [], 1
    for i, p in enumerate(like.placements):
        if p.is_shard(0):
            plan.append("batch")
        elif heads % (split * mesh.size(i)) == 0:     # even shards of the heads
            plan.append("heads")
            split *= mesh.size(i)
        else:
            plan.append(None)

    def placed(bd, hd):
        return [Shard(bd) if k == "batch" and bd is not None
                else Shard(hd) if k == "heads" and hd is not None else Replicate()
                for k in plan]

    def shard_of(a, d):
        pl = placed(*d)
        grad = [Partial() if k is not None and not x.is_shard() else x for x, k in zip(pl, plan)]
        return _as_dtensor(a, mesh).redistribute(mesh, pl).to_local(grad_placements=grad)

    outs = fn(*(shard_of(a, d) if isinstance(a, torch.Tensor) else a
                for a, d in zip(args, dims)))

    def whole(o, bd, hd):
        shape = list(o.shape)
        if bd is not None and "batch" in plan:
            shape[bd] = like.shape[0]
        if hd is not None and "heads" in plan:
            shape[hd] = heads
        return shape

    return tuple(_from_local(o, mesh, placed(*d), whole(o, *d)) for o, d in zip(outs, out_dims))


def replicate_residual(x: DTensor) -> DTensor:
    """x (B, ...) placed by its batch shards alone: Replicate on every other
    mesh dim (a partial sum reduced, another dim's shard gathered)."""
    return x.redistribute(x.device_mesh, _batch_placements(x.placements, 1))


def row_parallel_input(t, w):
    """t (..., K), the input of a product with w (K, N): a DTensor t that is
    replicated on a mesh dim that shards w's rows is sharded there on its
    last dim (a local slice), so the product is a partial sum and t's
    gradient is gathered here, before it meets the reshape that made t (a
    gradient sharded on H x D does not split into heads a shard would cut:
    40 or 56 over 16). Any other t passes as it is."""
    if not isinstance(t, DTensor) or not isinstance(w, DTensor):
        return t
    last = t.ndim - 1
    return placed(t, [Shard(last) if q.is_shard(0) and p.is_replicate() else p
                      for p, q in zip(t.placements, w.placements)])


def whole_heads(t: DTensor, heads: int) -> DTensor:
    """t (..., heads * head_dim) with its last dim gathered where its shards
    would cut a head (40 heads over 16 ranks): DTensor cannot split a
    sharded dim into uneven head shards, XLA pads them."""
    last = t.ndim - 1
    n = 1
    for i, p in enumerate(t.placements):
        if p.is_shard(last):
            n *= t.device_mesh.size(i)
    if heads % n == 0:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_shard(last) else p
                                          for p in t.placements])
