"""Logical-axis sharding rules for every parameter, cache and batch tree;
the port of src/repro/distributed/sharding.py, rule for rule.

Rules are driven by a leaf's name and shape, so one function covers all six
families:

  - vocab (embed / lm_head)            -> rows on "model"
  - attention q/k/v projections        -> columns (heads) on "model"
  - attention out / FFN down / out_proj-> rows on "model"
  - FFN gate/up, MoE expert FFNs       -> hidden dim on "model"
  - RWKV/Mamba head-structured leaves  -> heads on "model" when divisible
  - small leaves (norm gains, biases, routers, loras, B/C projections)
                                       -> replicated
  - batch dims                         -> ("pod", "data")
  - decode KV caches                   -> sequence on "model", batch on the
    data axes when divisible

ZeRO-style optimizer-state sharding: `zero_variant` adds the data axes to
the first replicated, divisible dimension of each leaf's spec.

The rules are pure functions over shapes and a mesh's axis names and sizes:
a mesh here is anything `mesh_axes` reads (a torch DeviceMesh with named
dims, or launch.mesh.AbstractMesh). A spec is a tuple with one entry per
dimension: None (replicated), an axis name, or a tuple of axis names; it
equals the reference's PartitionSpec entry for entry. The reference stacks
each layer's leaves along a leading L axis and its rules see that axis
(`stacked`); the port's per-layer list reports the same stacked specs, and
`placements` drops the L entry when it places one layer's tensor.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.tensor_parallel import spec_placements

# leaves that stay replicated regardless of shape (small / awkward to split)
_REPLICATED_NAMES = {
    "norm", "norm1", "norm2", "final_norm", "ln_x", "router", "mus", "mu_x",
    "mu_k", "mu_r", "w0", "lora_mix_a", "lora_mix_b", "lora_w_a", "lora_w_b",
    "conv_bias_x", "conv_bias_b", "conv_bias_c", "conv_b", "conv_c",
    "w_b", "w_c", "a_log", "dt_bias", "d_skip", "dt", "pos",
}
_ROW_SHARDED = {"embed", "lm_head", "wo", "w_down", "out_proj"}
_COL_SHARDED = {"wq", "wk", "wv", "wr", "wg", "w_gate", "w_up", "w_z", "w_x",
                "w_dt", "conv_x", "u", "wk_cm", "wv_cm"}


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or an AbstractMesh, in mesh order."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.sizes))


def _axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def _dp_axes(mesh) -> tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _dp_size(mesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in _dp_axes(mesh)) or 1


def _spec_for_param(name: str, shape: tuple[int, ...], mesh, stacked: bool) -> tuple:
    model = _axis_size(mesh, "model")
    ndim = len(shape)
    lead = 1 if stacked else 0

    base0 = name.split("/")[-1]
    if base0 in ("w_gate", "w_up", "w_down") and ndim - lead == 3:
        # MoE expert banks (E, D, F)/(E, F, D): expert-parallel over the
        # data axes when divisible, TP on the hidden dim
        e_dim, mid, last = lead, lead + 1, lead + 2
        spec: list[Any] = [None] * ndim
        ep = ep_axes_for(mesh, shape[e_dim])
        if ep is not None:
            spec[e_dim] = ep if len(ep) > 1 else ep[0]
        h_dim = last if base0 != "w_down" else mid  # the FFN hidden dim
        if shape[h_dim] % model == 0:
            spec[h_dim] = "model"
        return tuple(spec)

    def ok(dim_idx: int) -> bool:
        return shape[dim_idx] % model == 0 and shape[dim_idx] >= 256

    spec = [None] * ndim
    base = name.split("/")[-1]
    if base in _REPLICATED_NAMES or ndim == lead:
        return tuple(spec)
    if name.endswith("channel_mix/wv"):
        # RWKV channel-mix down-projection: rows (hidden) on "model"
        if shape[lead] % model == 0:
            spec[lead] = "model"
        return tuple(spec)
    if base in ("wk", "wv") and "attn" in name:
        # KV projections: shard heads only when every shard gets >= 1 head
        if shape[-1] % model == 0 and shape[-1] // model >= 128:
            spec[-1] = "model"
        return tuple(spec)
    if base in _ROW_SHARDED:
        # shard the first non-stack dim (rows); MoE w_down (E, F, D) -> F
        i = lead if shape[lead] % model == 0 and len(shape) - lead >= 2 else None
        if base == "w_down" and ndim - lead == 3:
            i = lead + 1
        if base in ("embed", "lm_head"):
            i = 0
        if i is not None and shape[i] % model == 0:
            spec[i] = "model"
        return tuple(spec)
    if base in _COL_SHARDED:
        if shape[-1] % model == 0 and (shape[-1] >= 128 or base == "u"):
            spec[-1] = "model"
        return tuple(spec)
    # default: replicate 1-D, column-shard >=2-D when divisible and large
    if ndim - lead >= 2 and ok(ndim - 1):
        spec[-1] = "model"
    return tuple(spec)


def ep_axes_for(mesh, num_experts: int):
    """Expert-parallel axes: the largest data-axes subset dividing E."""
    names = mesh_axes(mesh)
    for axes in (("pod", "data"), ("data",), ("pod",)):
        if all(a in names for a in axes):
            size = math.prod(names[a] for a in axes)
            if size > 1 and num_experts % size == 0:
                return axes
    return None


def _walk(tree, fn, path: tuple = (), stacked: bool = False):
    """fn(name, leaf, stacked) over a dict tree; a list of layer dicts
    answers for the stacked leaf (the reference's layout) with each layer's
    own entry."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,), stacked) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path, True) for v in tree]
    return fn("/".join(path), tree, stacked)


def _stacked_shape(leaf, stacked: bool, num: int) -> tuple:
    return ((num,) if stacked else ()) + tuple(leaf.shape)


def param_pspecs(params, mesh):
    """A spec tree matching a params tree (the port's: layers a list, each
    layer's entry the spec of the reference's stacked leaf)."""
    num = len(params.get("layers", ()))

    def assign(name, leaf, stacked):
        return _spec_for_param(name, _stacked_shape(leaf, stacked, num), mesh, stacked)

    return _walk(params, assign)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------
def batch_pspecs(batch: dict, mesh) -> dict:
    """Shard global-batch dims over ("pod", "data")."""
    dp = _dp_axes(mesh)
    dps = _dp_size(mesh)

    def assign(name, leaf):
        if name == "positions":                     # (3, B, S)
            return (None, dp, None) if leaf.shape[1] % dps == 0 else ()
        rest = (None,) * (len(leaf.shape) - 1)
        if leaf.shape[0] % dps == 0:
            return (dp, *rest)
        return (None, *rest)

    return {k: assign(k, v) for k, v in batch.items()}


def cache_pspecs(cache: dict, cfg, mesh) -> dict:
    """Decode-cache sharding. KV caches shard sequence on "model" and batch
    on the data axes when divisible; recurrent state shards heads on
    "model". Falls back to spreading the sequence over every axis for the
    B=1 long-context cells."""
    dp = _dp_axes(mesh)
    dps = _dp_size(mesh)
    model = _axis_size(mesh, "model")

    def assign(name, leaf):
        shape = tuple(leaf.shape)
        if name == "pos":
            return ()
        if name in ("k", "v"):                      # (L, B, KV, S, hd)
            _, b, _, s, _ = shape
            if b % dps == 0 and s % model == 0:
                return (None, dp, None, "model", None)
            if s % (dps * model) == 0:              # long-context, B == 1
                return (None, None, None, dp + ("model",), None)
            return ()
        if name in ("state", "ssm_state"):          # (L, B, H, N, N|P)
            bspec = dp if shape[1] % dps == 0 else None
            return (None, bspec, "model" if shape[2] % model == 0 else None, None, None)
        if name == "conv_state":                    # (L, B, W-1, C)
            bspec = dp if shape[1] % dps == 0 else None
            return (None, bspec, None, None)
        if name in ("x_prev_att", "x_prev_ffn"):    # (L, B, D)
            bspec = dp if shape[1] % dps == 0 else None
            return (None, bspec, None)
        return ()

    return {k: assign(k, v) for k, v in cache.items()}


def tokens_pspec(tokens_shape, mesh) -> tuple:
    dp = _dp_axes(mesh)
    if tokens_shape[0] % _dp_size(mesh) == 0:
        return (dp, *([None] * (len(tokens_shape) - 1)))
    return (None,) * len(tokens_shape)


# ---------------------------------------------------------------------------
# ZeRO-style optimizer-state sharding
# ---------------------------------------------------------------------------
def zero_variant(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Add the data axes to the first replicated, divisible dim of `spec`."""
    dp = _dp_axes(mesh)
    dps = _dp_size(mesh)
    if dps == 1:
        return spec
    used = {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    if used & set(dp):   # already (expert-)sharded over the data axes
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, n) in enumerate(zip(parts, shape)):
        if p is None and n % dps == 0 and n >= dps:
            parts[i] = dp
            return tuple(parts)
    return tuple(parts)


def zero_pspecs(params, mesh):
    num = len(params.get("layers", ()))

    def assign(name, leaf, stacked):
        shape = _stacked_shape(leaf, stacked, num)
        return zero_variant(_spec_for_param(name, shape, mesh, stacked), shape, mesh)

    return _walk(params, assign)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------
def placements(spec: tuple, shape: tuple[int, ...], mesh) -> list:
    """A spec for a tensor of `shape` -> DTensor placements on `mesh`, one
    per mesh dim: Shard(i) where tensor dim i holds that axis, else
    Replicate(). A spec one entry longer than the shape is a stacked layer
    leaf's, read for one layer of the port's list: its L entry is dropped,
    and where it held the data axes (ZeRO over the layers, which a list of
    per-layer tensors cannot express) they move to the layer tensor's
    first replicated, divisible dim instead."""
    if len(spec) == len(shape) + 1:
        spec = zero_variant(spec[1:], shape, mesh) if spec[0] is not None else spec[1:]
    return spec_placements(spec, mesh_axes(mesh))


def distribute(t: torch.Tensor, mesh, spec: tuple):
    """A full tensor, identical on every rank of `mesh`, -> a DTensor placed
    by `spec`: each rank keeps its own shard, nothing is sent."""
    return distribute_tensor(t, mesh, placements(spec, tuple(t.shape), mesh),
                             src_data_rank=None)
