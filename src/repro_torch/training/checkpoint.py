"""Step-atomic checkpoints with restart and elastic reshard; the port of
src/repro/training/checkpoint.py, in its on-disk format exactly.

Layout:
    <dir>/step_00001230/
        manifest.json        {step, leaves: [{key, file, shape, dtype, crc32,
                              shard, num_shards}]}
        leaf_000000.npy ...
    <dir>/LATEST             text file naming the newest complete step dir

Write protocol: leaves and manifest go into a `.tmp-<step>` directory which
is atomically renamed; LATEST is rewritten last, so a crash leaves either
the old or the new checkpoint whole, never a torn one. Every leaf carries a
CRC32 that restore verifies: a corrupt or incomplete checkpoint is skipped
and the one before it used (restore_latest walks backwards).

Keys are the reference's: the '/'-joined dict path, the layers stacked along
a leading L axis (params/layers/attn/wq, opt/m/layers/attn/wq, ...), the
leaves numbered in the order of their sorted keys, as the reference's
pytree flattening orders them. bf16 is stored as its raw uint16 bits under
the logical dtype "bfloat16". So a checkpoint written by either package
restores in the other.

Elastic reshard: DTensor leaves are written as full tensors (every rank of
their mesh takes part in the gather; one rank writes) and restored into the
placements of the `like` tree, as the reference restores with device_put.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.weights import bf16_bits


def _transpose(layers: list):
    """A list of per-layer dicts -> one dict whose leaves are per-layer lists."""
    if isinstance(layers[0], dict):
        return {k: _transpose([lp[k] for lp in layers]) for k in layers[0]}
    return list(layers)


def _untranspose(tree, num: int) -> list:
    def pick(t, l):
        return {k: pick(v, l) for k, v in t.items()} if isinstance(t, dict) else t[l]
    return [pick(tree, l) for l in range(num)]


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) in sorted key order; a stacked leaf is a per-layer list."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if k == "layers" and isinstance(v, list):
            v = _transpose(v)
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out += _flatten(v, key + "/")
        else:
            out.append((key, v))
    return out


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array to store, logical dtype) of one tensor; a DTensor is gathered
    whole first (a collective over its mesh)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        return bf16_bits(t), "bfloat16"
    a = t.detach().cpu().numpy()
    return a, str(a.dtype)


def _leaf_array(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, list):
        parts = [_host(t) for t in leaf]
        return np.stack([a for a, _ in parts]), parts[0][1]
    return _host(leaf)


def save(ckpt_dir: str, step: int, tree: Any, write: bool = True) -> str:
    """Write `tree` (nested dicts of tensors, layers a list) as step `step`.
    Every rank holding DTensor leaves must call it; only ranks with `write`
    touch the disk."""
    items = [(key, *_leaf_array(leaf)) for key, leaf in _flatten(tree)]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not write:
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (key, arr, logical_dtype) in enumerate(items):
        fname = f"leaf_{i:06d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(arr.shape),
            "dtype": logical_dtype, "crc32": zlib.crc32(arr.tobytes()),
            "shard": 0, "num_shards": 1,
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):  # re-save of the same step
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(os.path.join(ckpt_dir, ".LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(ckpt_dir, ".LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))
    return final


class CorruptCheckpoint(RuntimeError):
    pass


def _to_like(arr: np.ndarray, logical_dtype: str, like: torch.Tensor) -> torch.Tensor:
    if logical_dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, DTensor):
        t = t.to(like.to_local().device, like.dtype)
        return distribute_tensor(t, like.device_mesh, like.placements, src_data_rank=None)
    return t.to(like.device, like.dtype)


def _set(tree: dict, key: str, value) -> None:
    *path, last = key.split("/")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _load_dir(path: str, like: Any) -> tuple[int, Any]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    arrays = {}
    for key, leaf in _flatten(like):        # read and verify everything first
        e = by_key.get(key)
        if e is None:
            raise CorruptCheckpoint(f"{path}: missing leaf {key}")
        arr = np.load(os.path.join(path, e["file"]))
        if zlib.crc32(arr.tobytes()) != e["crc32"]:
            raise CorruptCheckpoint(f"{path}: CRC mismatch for {key}")
        arrays[key] = (arr, e["dtype"], leaf)
    out: dict = {}
    for key, (arr, dtype, leaf) in arrays.items():
        if isinstance(leaf, list):
            value = [_to_like(arr[l], dtype, t) for l, t in enumerate(leaf)]
        else:
            value = _to_like(arr, dtype, leaf)
        _set(out, key, value)
    return manifest["step"], _restore_layers(out, like)


def _restore_layers(out, like):
    """Turn each stacked "layers" dict of per-layer lists back into the
    port's list of per-layer dicts."""
    if not isinstance(like, dict):
        return out
    res = {}
    for k, v in like.items():
        if k == "layers" and isinstance(v, list):
            res[k] = _untranspose(out[k], len(v))
        else:
            res[k] = _restore_layers(out[k], v)
    return res


def restore_latest(ckpt_dir: str, like: Any):
    """Restore the newest intact checkpoint (walks back past corrupt ones)
    into the structure, dtypes, devices and placements of `like`.

    Returns (step, tree) or (None, None) when nothing restorable exists."""
    if not os.path.isdir(ckpt_dir):
        return None, None
    candidates = sorted(
        (d for d in os.listdir(ckpt_dir) if d.startswith("step_")), reverse=True)
    latest_file = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(latest_file):
        with open(latest_file) as f:
            named = f.read().strip()
        if named in candidates:
            candidates.remove(named)
            candidates.insert(0, named)
    for cand in candidates:
        try:
            return _load_dir(os.path.join(ckpt_dir, cand), like)
        except (CorruptCheckpoint, FileNotFoundError, json.JSONDecodeError):
            continue
    return None, None
