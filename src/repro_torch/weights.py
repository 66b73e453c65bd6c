"""Bridge parameter and optimizer-state trees between the reference's layout
and the port's.

The reference draws its weights from `jax.random` (src/repro/models/
backbone.py `init_params`), which torch cannot replay, so a parity test
converts the reference's pytree to numpy arrays and hands it here. The
reference stacks every layer leaf along a leading L axis (for `lax.scan`);
the port keeps a list of per-layer dicts. Both directions take a params
tree or an optimizer state ({"step", "m", "v", "master"}, each of m, v and
master a params tree): wherever a "layers" key appears, the L axis is split
into the list (`from_reference`) or the list stacked back onto it
(`to_reference`); every other leaf crosses as it is. numpy has no bfloat16,
so a bf16 leaf crosses widened to fp32, exactly: through a uint16 view of
its bits, never through a rounding.
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


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a bf16 tensor as a uint16 numpy array (host copy)."""
    return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)


def widen_bf16(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bits -> the same values as fp32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of t; bf16 widened exactly to fp32."""
    if t.dtype == torch.bfloat16:
        return widen_bf16(bf16_bits(t))
    return t.detach().cpu().numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def stack_layers(layers: list, fn=lambda t: t):
    """The port's per-layer list -> one dict of leaves stacked along a
    leading L axis (np.stack of fn of each layer's leaf)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lp[k] for lp in layers], fn) for k in first}
    return np.stack([fn(t) for t in layers])


def to_reference(tree: dict, cfg: ModelConfig) -> dict:
    """Port params or optimizer state -> the reference's layout as nested
    dicts of numpy arrays: layers stacked along a leading L axis of
    cfg.num_layers, bf16 widened exactly to fp32."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            assert len(v) == cfg.num_layers, (len(v), cfg.num_layers)
            out[k] = stack_layers(v, to_numpy)
        elif isinstance(v, dict):
            out[k] = to_reference(v, cfg)
        else:
            out[k] = to_numpy(v)
    return out


def from_reference(tree_np: dict, cfg: ModelConfig, device=None) -> dict:
    """Reference params or optimizer state (nested dicts of numpy arrays) ->
    the port's layout on `device` (the card unless the caller names the
    CPU)."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree_np.items():
        if k == "layers":
            out[k] = [_map(v, lambda a, l=l: _tensor(np.asarray(a)[l], dev))
                      for l in range(cfg.num_layers)]
        elif isinstance(v, dict):
            out[k] = from_reference(v, cfg, dev)
        else:
            out[k] = _tensor(v, dev)
    return out
