"""Synthetic token data; the port of src/repro/training/data.py.

Deterministic, seekable batch stream: a batch is a function of (seed, step)
alone, drawn by numpy exactly as the reference draws it, so a restart
rebuilds the stream from the restored step with no pipeline state to
snapshot. Batches are placed with the mesh's batch placements
(sharding.batch_pspecs), or on the one device without a mesh.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int, step: int,
                    frontend: bool = False) -> dict:
    """One deterministic batch (numpy, host), == the reference's."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    out: dict = {}
    if cfg.frontend is not None or frontend:
        out["embeds"] = rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32) * 0.02
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)
    if cfg.attn is not None and cfg.attn.m_rope_sections is not None:
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (batch, seq))
        out["positions"] = np.broadcast_to(pos, (3, batch, seq)).copy()
    out["labels"] = rng.integers(0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)
    return out


def to_device(host: dict, device, dtype=torch.bfloat16) -> dict:
    """A numpy batch -> tensors on `device`; fp32 arrays (frame or patch
    embeddings) cast to `dtype`, as the reference's pipeline casts them."""
    out = {}
    for k, v in host.items():
        t = torch.from_numpy(v)
        out[k] = t.to(device, dtype if t.dtype == torch.float32 else t.dtype)
    return out


class DataPipeline:
    """Infinite stream of placed batches, seekable by step. With a mesh
    (a DeviceMesh) each batch is a dict of DTensors placed by
    batch_pspecs; without one, tensors on `device` (the card unless the
    caller names the CPU)."""

    def __init__(self, cfg: ModelConfig, mesh=None, batch: int = 8, seq: int = 64,
                 seed: int = 0, start_step: int = 0, dtype=torch.bfloat16,
                 device=None):
        self.cfg, self.mesh = cfg, mesh
        self.batch, self.seq, self.seed = batch, seq, seed
        self.step = start_step
        self.dtype = dtype
        self.device = (torch.device(mesh.device_type, _local_index(mesh))
                       if mesh is not None else resolve_device(device))

    def seek(self, step: int) -> None:
        self.step = step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        host = synthetic_batch(self.cfg, self.batch, self.seq, self.seed, self.step)
        self.step += 1
        batch = to_device(host, self.device, self.dtype)
        if self.mesh is None:
            return batch
        from repro_torch.training.train_step import shard_batch

        return shard_batch(batch, self.mesh)


def _local_index(mesh):
    """This rank's card index under a cuda mesh (None on the CPU)."""
    return torch.cuda.current_device() if mesh.device_type == "cuda" else None
