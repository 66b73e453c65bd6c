"""AdamW with fp32 master weights and moments (mixed-precision training);
the port of src/repro/training/optimizer.py, op for op.

Plain functions over the port's param trees (dicts of tensors, layers a
list), not `torch.optim`, whose state layout is not the reference's. The
state is {"step": int32 scalar, "m", "v", "master": fp32 trees shaped like
the params}. `apply_updates` updates m, v, master and the params in place and
returns them: the reference's jitted step donates the same buffers
(`donate_argnums`), and on one card a copy of the fp32 state would not fit
beside it at full width. The math is sharding-agnostic: the leaves may be
DTensors (the sharded step keeps the state ZeRO-sharded, the params
tensor-parallel), and a param is copied back in its own placements.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def tree_map(fn, *trees):
    """fn over the leaves of trees of one structure (dicts and lists)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def init_opt_state(params):
    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "master": tree_map(lambda p: p.detach().float().clone(), params),
    }


def _schedule(cfg: AdamWConfig, step_f):
    """Linear warmup to cfg.lr over cfg.warmup_steps, in fp32."""
    return cfg.lr * torch.clamp(step_f / max(cfg.warmup_steps, 1), max=1.0)


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in fp32 (a replicated
    scalar for DTensor leaves)."""
    total = sum(g.float().square().sum() for g in tree_leaves(tree))
    if isinstance(total, DTensor):
        total = total.full_tensor()
    return torch.sqrt(total)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step: global-norm clipping, linear warmup, bias correction
    and decoupled weight decay inside the update. Updates `state` and
    `params` in place (params cast back to their dtype) and returns
    (params, state, metrics)."""
    step = _local(state["step"]) + 1
    step_f = step.float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _schedule(cfg, step_f)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=step.device), step_f)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=step.device), step_f)

    def upd(g, m, v, w):
        # on the local shards: a DTensor's leaves here share their placements
        # (grads are placed like the state by the caller), so the update is
        # elementwise on each shard
        g, m, v, w = (_local(x) for x in (g, m, v, w))
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        w.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * w))

    tree_map(upd, grads, state["m"], state["v"], state["master"])
    tree_map(_copy_back, params, state["master"])
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _copy_back(p, w):
    """p <- w cast to p's dtype, in p's placements."""
    if isinstance(p, DTensor) and w.placements != p.placements:
        w = w.redistribute(p.device_mesh, p.placements)
    _local(p).copy_(_local(w))
