"""Meshes; the port of src/repro/launch/mesh.py.

Production meshes, as shapes only (nothing here allocates 256 devices):
single pod (16, 16) = ("data", "model"), multi-pod (2, 16, 16) = ("pod",
"data", "model"). `make_host_mesh` builds a real torch DeviceMesh over
ranks of the default process group (gloo on the CPU, nccl on cards), which
the caller (launch/train.py, a test) has initialised.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, with no devices behind it: what the
    sharding rules read."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"shape {self.sizes} vs axis_names {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1, ranks=None,
                   device_type: str | None = None) -> DeviceMesh:
    """A (data, model) DeviceMesh over `ranks` of the default process group
    (its first data * model ranks if None), row-major: ranks [i*model,
    (i+1)*model) form data row i. Only the mesh's own ranks call it: each
    builds the two groups it belongs to (its column, its row) with a
    group-local handshake, so ranks outside the mesh, which may have left,
    take no part. The caller's rank must be in `ranks`."""
    world = dist.get_world_size()
    ranks = list(range(data * model)) if ranks is None else list(ranks)
    if data * model != len(ranks) or len(ranks) > world:
        raise ValueError(f"mesh {data} x {model} over ranks {ranks} of {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(ranks).reshape(data, model)
    i, j = (grid == dist.get_rank()).nonzero()[0].tolist()
    groups = [dist.new_group(grid[:, j].tolist(), use_local_synchronization=True),
              dist.new_group(grid[i].tolist(), use_local_synchronization=True)]
    return DeviceMesh.from_group(groups, device_type, mesh=grid,
                                 mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> tuple[str, ...]:
    """The axes a global-batch dimension shards over."""
    names = mesh.mesh_dim_names if hasattr(mesh, "mesh_dim_names") else mesh.axis_names
    return tuple(a for a in names if a in ("pod", "data"))
