"""Gradient compression for the data-parallel sync path; the port of
src/repro/distributed/compression.py over torch.distributed.

int8 all-reduce with a shared (all-reduce MAX) scale: 1 byte an element on
the wire instead of 4, plus an error-feedback residual so that quantization
error does not bias training (it is re-injected into the next step's
gradients). The int8 payloads travel by all-gather and are summed locally,
as in the reference.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.training.optimizer import tree_map


def int8_quantize(x, scale):
    """round(x / scale) to the nearest integer, halves to even (as
    jnp.round), clipped to +-127, as int8."""
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8)


def _shared_scale(x32, group):
    """max |x| over every rank of `group`, over 127 (at least 1e-12 / 127)."""
    m = x32.abs().max()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    return torch.clamp(m, min=1e-12) / 127.0


def _mean_int8(x32, scale, group):
    n = dist.get_world_size(group)
    q = int8_quantize(x32, scale)
    allq = [torch.empty_like(q) for _ in range(n)]
    dist.all_gather(allq, q, group=group)            # int8 on the wire
    return torch.stack(allq).float().sum(dim=0) * scale / n


def int8_allreduce_mean(x, group=None):
    """Mean of x over the ranks of `group` (the default group if None) with
    int8 payloads."""
    x32 = x.float()
    return _mean_int8(x32, _shared_scale(x32, group), group)


def _map_stacked(fn, grads, residual):
    """fn(list of grads, list of residuals) -> (list, list) over the tree,
    a list holding one stacked leaf: every layer's tensor of one name in
    the port's layer list (the reference's (L, ...) leaf), else the leaf
    alone."""
    if isinstance(grads, dict):
        pairs = {k: _map_stacked(fn, grads[k], residual[k]) for k in grads}
        return ({k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()})
    if isinstance(grads, list):                       # the layers
        if isinstance(grads[0], dict):
            pairs = {k: _map_stacked(fn, [lp[k] for lp in grads], [lr[k] for lr in residual])
                     for k in grads[0]}
            n = len(grads)
            return ([{k: v[0][i] for k, v in pairs.items()} for i in range(n)],
                    [{k: v[1][i] for k, v in pairs.items()} for i in range(n)])
        return fn(grads, residual)
    synced, err = fn([grads], [residual])
    return synced[0], err[0]


def compress_tree_mean(grads, group=None, residual=None):
    """Compressed mean all-reduce over a gradient tree with error feedback.
    Returns (synced grads in their dtypes, the new residual: what this
    rank's quantization failed to send). One scale serves each leaf of the
    reference's layout, so the layers of one name share it, as the
    reference's stacked leaf does."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(gs, rs):
        g32 = [g.float() + r for g, r in zip(gs, rs)]
        scale = _shared_scale(torch.stack([x.abs().max() for x in g32]), group)
        synced = [_mean_int8(x, scale, group).to(g.dtype) for x, g in zip(g32, gs)]
        return synced, [x - int8_quantize(x, scale).float() * scale for x in g32]

    return _map_stacked(one, grads, residual)
