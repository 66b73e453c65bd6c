"""Bridge the reference's parameters into the port's.

The reference draws its weights from `jax.random` (src/repro/models/
backbone.py `init_params`), which torch cannot replay, so a parity test
converts the reference's param pytree to numpy arrays and hands it here.
The stacked `layers` pytree (every leaf with a leading L axis, for
`lax.scan`) becomes the port's list of per-layer dicts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no bf16: widen, exactly
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_reference(params_np: dict, cfg: ModelConfig, device=None) -> dict:
    """Reference params (nested dicts of numpy arrays) -> port params on
    `device` (the card unless the caller names the CPU)."""
    dev = resolve_device(device)
    layers = [_map(params_np["layers"], lambda a, l=l: _tensor(a[l], dev))
              for l in range(cfg.num_layers)]
    return {"tok": _map(params_np["tok"], lambda a: _tensor(a, dev)),
            "layers": layers,
            "final_norm": _tensor(params_np["final_norm"], dev)}
