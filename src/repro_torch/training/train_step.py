"""Training steps; the port of src/repro/training/train_step.py.

    loss_and_grads(params, batch, cfg, exec_cfg, microbatches) -> (loss, grads)
    train_step(params, opt_state, batch, cfg, opt_cfg, exec_cfg, microbatches)
                                              -> (params, opt_state, metrics)
    make_sharded_train_step(mesh, cfg, ...)   -> step(params, opt_state, batch)
    make_compressed_train_step(cfg, ...)      -> step(params, opt_state, residual, batch)
    init_residual(params)                     -> the per-rank error-feedback residual

Gradients come from torch autograd over `backbone.loss_fn`, as the
reference's from `jax.value_and_grad`. The sharded step runs the same
train_step on DTensors: params placed by `param_pspecs` (tensor parallel on
"model"), optimizer state by `zero_pspecs` (ZeRO over the data axes), the
batch over the data axes; DTensor inserts the collectives the reference
leaves to XLA's partitioner. Its exec_cfg takes the reference's sharding
knobs, as the reference's train_step does: carry_spec places the residual
stream on its sequence shards between layers, ep_axes lays the MoE
dispatch out expert-major (models/layers.py ExecConfig). The compressed step is data parallel over a
process group with replicated params, the gradient sync an int8 all-reduce
with an error-feedback residual (distributed/compression.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed import sharding
from repro_torch.distributed.compression import compress_tree_mean
from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DEFAULT_EXEC, ExecConfig
from repro_torch.training.optimizer import (
    AdamWConfig,
    apply_updates,
    tree_leaves,
    tree_map,
)


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def value_and_grad(params, batch, cfg: ModelConfig, exec_cfg: ExecConfig):
    """(loss, grads) of backbone.loss_fn at params; grads in the params'
    dtypes and placements (a param the loss does not reach gets zeros)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = backbone.loss_fn(_unflatten(params, leaves), batch, cfg, exec_cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, grads)


def _chunks(v, n: int, dim: int) -> tuple:
    """n equal slices of v along dim. A DTensor is sliced on each rank's
    shard, so a batch sharded over the data axes stays so (DTensor would
    gather a sharded dim to split it): microbatch i holds every rank's i-th
    slice, and the microbatches still cover the batch once."""
    if not isinstance(v, DTensor):
        return torch.chunk(v, n, dim=dim)
    local = v.to_local()
    if local.shape[dim] % n or v.shape[dim] % n:
        raise ValueError(f"a batch of {v.shape[dim]} ({local.shape[dim]} on this rank) "
                         f"does not split into {n} microbatches")
    shape = list(v.shape)
    shape[dim] //= n
    stride = torch.empty(shape, device="meta").stride()
    return tuple(DTensor.from_local(c, v.device_mesh, v.placements, run_check=False,
                                    shape=torch.Size(shape), stride=stride)
                 for c in torch.chunk(local, n, dim=dim))


def _split(batch: dict, n: int) -> list[dict]:
    """n microbatches of batch; positions (3, B, S) split on dim 1."""
    parts = {k: _chunks(v, n, 1 if k == "positions" else 0) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def loss_and_grads(params, batch, cfg: ModelConfig, exec_cfg: ExecConfig,
                   microbatches: int = 1):
    """Value and gradient, accumulated in fp32 over `microbatches` equal
    slices of the batch and averaged."""
    if microbatches <= 1:
        return value_and_grad(params, batch, cfg, exec_cfg)
    b = batch["labels"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
    loss_acc = torch.zeros((), device=batch["labels"].device)
    g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    for mb in _split(batch, microbatches):
        loss, g = value_and_grad(params, mb, cfg, exec_cfg)
        loss_acc = loss_acc + loss
        tree_map(lambda a, x: a.add_(x.float()), g_acc, g)
        del g
    inv = 1.0 / microbatches
    return loss_acc * inv, tree_map(lambda g: g * inv, g_acc)


def train_step(params, opt_state, batch, cfg: ModelConfig,
               opt_cfg: AdamWConfig = AdamWConfig(),
               exec_cfg: ExecConfig = DEFAULT_EXEC,
               microbatches: int = 1):
    """One AdamW step on `batch`; the params and the state are updated in
    place (optimizer.apply_updates) and returned with {"loss", "grad_norm",
    "lr"}. The gradients are cast to bf16 before the update, fp32 configs
    included, as the reference's step pins its gradient sync to bf16."""
    loss, grads = loss_and_grads(params, batch, cfg, exec_cfg, microbatches)
    grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
    params, opt_state, metrics = apply_updates(opt_cfg, params, grads, opt_state)
    return params, opt_state, {"loss": loss, **metrics}


# ---------------------------------------------------------------------------
# sharded over a device mesh (DTensor)
# ---------------------------------------------------------------------------
def shard_params(params, mesh):
    """params (full tensors, identical on every rank) -> DTensors placed by
    param_pspecs."""
    specs = sharding.param_pspecs(params, mesh)
    return tree_map(lambda p, s: sharding.distribute(p, mesh, s), params, specs)


def shard_opt_state(opt_state, params, mesh):
    """An optimizer state of full tensors -> m, v and master placed by
    zero_pspecs; the step stays a plain scalar, the same on every rank."""
    zspec = sharding.zero_pspecs(params, mesh)
    out = {"step": opt_state["step"]}
    for k in ("m", "v", "master"):
        out[k] = tree_map(lambda x, s: sharding.distribute(x, mesh, s), opt_state[k], zspec)
    return out


def shard_batch(batch: dict, mesh) -> dict:
    """A full batch (identical on every rank) -> DTensors placed by
    batch_pspecs."""
    specs = sharding.batch_pspecs(batch, mesh)
    return {k: sharding.distribute(v, mesh, specs[k]) for k, v in batch.items()}


def make_sharded_train_step(mesh, cfg: ModelConfig,
                            opt_cfg: AdamWConfig = AdamWConfig(),
                            exec_cfg: ExecConfig = DEFAULT_EXEC,
                            microbatches: int = 1):
    """train_step over DTensors on `mesh` (launch.mesh.make_host_mesh).

    It takes params from `shard_params`, a state from `shard_opt_state` and
    a batch from `shard_batch` (or DataPipeline over the mesh), and returns
    them in the same placements with replicated metrics. The gradients leave
    autograd in the params' placements, partial over the data axes, and are
    reduced into the state's ZeRO placements before the update; the updated
    master is gathered back into the params' placements."""
    def step(params, opt_state, batch):
        with implicit_replication():
            loss, grads = loss_and_grads(params, batch, cfg, exec_cfg, microbatches)
            grads = tree_map(lambda g, m: g.to(torch.bfloat16).redistribute(
                m.device_mesh, m.placements), grads, opt_state["m"])
            params, opt_state, metrics = apply_updates(opt_cfg, params, grads, opt_state)
        loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
        return params, opt_state, {"loss": loss, **metrics}

    return step


# ---------------------------------------------------------------------------
# int8-compressed data parallel
# ---------------------------------------------------------------------------
def make_compressed_train_step(cfg: ModelConfig,
                               opt_cfg: AdamWConfig = AdamWConfig(),
                               exec_cfg: ExecConfig = DEFAULT_EXEC,
                               group=None):
    """Data-parallel step over the process group `group` (the default group
    if None) with the int8 error-feedback gradient all-reduce. Each rank
    holds the replicated params and state, its own slice of the batch and
    its own residual: step(params, opt_state, residual, batch) ->
    (params, opt_state, residual, metrics), the loss averaged over ranks."""
    def step(params, opt_state, residual, batch):
        loss, grads = value_and_grad(params, batch, cfg, exec_cfg)
        grads, residual = compress_tree_mean(grads, group, residual)
        dist.all_reduce(loss, group=group)
        loss = loss / dist.get_world_size(group)
        params, opt_state, metrics = apply_updates(opt_cfg, params, grads, opt_state)
        return params, opt_state, residual, {"loss": loss, **metrics}

    return step


def init_residual(params):
    """This rank's error-feedback residual: fp32 zeros shaped like the
    params (the reference stacks one per shard along a leading axis)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
