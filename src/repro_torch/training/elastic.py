"""Elastic training runner: checkpoint/restart and re-mesh on rank loss; the
port of src/repro/training/elastic.py over torch.distributed.

Every rank of the default process group runs one ElasticTrainer. The runner
owns the (mesh, params, opt_state, data) quartet and a step loop that
survives injected failures: on `fail_devices(n)` the last n ranks drop out,
the survivors build the largest usable (data, model) mesh over themselves,
restore the newest intact checkpoint into its placements (checkpoint leaves
are full tensors, so resharding is a placement), seek the data pipeline to
the restored step, and go on. A dropped rank takes part in nothing after
that: its `run` returns and it leaves. On one card the mesh is (1, 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, mesh_shape
from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import TRAIN_EXEC, ExecConfig, torch_dtype
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataPipeline
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import (
    make_sharded_train_step,
    shard_opt_state,
    shard_params,
)


class NodeFailure(RuntimeError):
    """Raised (or injected) when ranks drop out mid-run."""


def _usable_mesh(n: int, model_axis: int) -> tuple[int, int]:
    """Largest (data, model) mesh over n surviving ranks."""
    model_axis = min(model_axis, n)
    while n % model_axis:
        model_axis -= 1
    return n // model_axis, model_axis


@dataclasses.dataclass
class ElasticTrainer:
    cfg: ModelConfig
    batch: int
    seq: int
    ckpt_dir: str
    opt_cfg: AdamWConfig = AdamWConfig()
    # the reference's default ExecConfig, which is its training mode
    exec_cfg: ExecConfig = TRAIN_EXEC
    model_axis: int = 1
    ckpt_every: int = 10
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        if not dist.is_initialized():
            raise RuntimeError("ElasticTrainer runs over torch.distributed: "
                               "init_process_group first (launch/train.py does)")
        self.device = resolve_device(self.device)
        self.ranks = list(range(dist.get_world_size()))
        self.rank = dist.get_rank()
        self.mesh = None
        self.step = 0
        self._build(restore=True)

    @property
    def active(self) -> bool:
        """Whether this rank is in the current mesh."""
        return self.mesh is not None

    @property
    def mesh_shape(self) -> dict:
        return mesh_shape(self.mesh)

    # ------------------------------------------------------------------
    def _build(self, restore: bool) -> None:
        data, model = _usable_mesh(len(self.ranks), self.model_axis)
        used = self.ranks[: data * model]
        if self.rank not in used:
            self.mesh = None
            return
        self.mesh = make_host_mesh(data, model, used, self.device.type)
        self._writer = self.rank == used[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        full = backbone.init_params(gen, self.cfg)
        params = shard_params(full, self.mesh)
        opt = shard_opt_state(init_opt_state(full), full, self.mesh)
        del full
        if restore:
            got_step, state = ckpt.restore_latest(self.ckpt_dir, {"params": params, "opt": opt})
            if got_step is not None:
                self.step = got_step
                params, opt = state["params"], state["opt"]
        self.params, self.opt = params, opt
        self.pipeline = DataPipeline(self.cfg, self.mesh, self.batch, self.seq,
                                     seed=self.seed, start_step=self.step,
                                     dtype=torch_dtype(self.cfg))
        self._step_fn = make_sharded_train_step(self.mesh, self.cfg, self.opt_cfg,
                                                self.exec_cfg)

    # ------------------------------------------------------------------
    def fail_devices(self, n: int) -> None:
        """Simulate losing the last n ranks; triggers a re-mesh and restore
        on the survivors."""
        if n >= len(self.ranks):
            raise ValueError("cannot lose every rank")
        self.ranks = self.ranks[: len(self.ranks) - n]
        self._build(restore=True)

    def run(self, steps: int, on_step: Optional[Callable] = None,
            fail_at: Optional[dict[int, int]] = None) -> list[float]:
        """Run `steps` more steps; `fail_at={step: n_ranks}` injects
        failures. Returns the loss history (restarts visible as re-runs); a
        rank dropped on the way returns what it ran before it left."""
        losses = []
        target = self.step + steps
        while self.active and self.step < target:
            if fail_at and self.step in fail_at:
                self.fail_devices(fail_at.pop(self.step))
                continue
            batch = next(self.pipeline)
            self.params, self.opt, metrics = self._step_fn(self.params, self.opt, batch)
            self.step += 1
            losses.append(float(metrics["loss"]))
            if on_step:
                on_step(self.step, metrics)
            if self.step % self.ckpt_every == 0:
                ckpt.save(self.ckpt_dir, self.step, {"params": self.params, "opt": self.opt},
                          write=self._writer)
                self._barrier()
        return losses

    def _barrier(self) -> None:
        """Every rank of the mesh waits here until all have arrived (a
        barrier along each mesh dim in turn): after a save, no rank may
        restore, after a re-mesh, before the writer's files are whole.
        Creating the new mesh's groups synchronises nothing by itself."""
        ids = [self.device.index] if self.device.type == "cuda" else None
        for dim in range(self.mesh.ndim):
            dist.barrier(group=self.mesh.get_group(dim), device_ids=ids)
