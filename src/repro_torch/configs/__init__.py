"""Architecture registry and the dry-run's shapes.

Every assigned architecture is selectable by id (``--arch <id>``); each
shape maps to the step function the dry-run lowers:

    train_4k    -> train_step   (seq 4096,  global batch 256)
    prefill_32k -> prefill      (seq 32768, global batch 32)
    decode_32k  -> serve_step   (KV len 32768, global batch 128)
    long_500k   -> serve_step   (KV/state len 524288, global batch 1)

``long_500k`` runs only for the sub-quadratic archs (ssm/hybrid); the 8
pure full-attention archs record a documented skip (DESIGN.md §4).

``input_specs`` gives each cell's inputs as tensors that hold no memory
(meta, or fake under the caller's FakeTensorMode), in the reference's
trees; launch/dryrun.py places them on a fake production mesh.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig, reduced

_ARCH_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "glm4-9b": "glm4_9b",
    "granite-20b": "granite_20b",
    "yi-34b": "yi_34b",
    "yi-6b": "yi_6b",
    "rwkv6-7b": "rwkv6_7b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "zamba2-2.7b": "zamba2_2p7b",
    # the paper's own serving models
    "llama-7b": "llama_paper",
    "llama-1b": "llama_paper",
    "llama-300m": "llama_paper",
}

ARCH_IDS = list(_ARCH_MODULES)[:10]  # the 10 assigned architectures
PAPER_MODELS = ["llama-7b", "llama-1b", "llama-300m"]


def get_config(arch: str) -> ModelConfig:
    mod_name = _ARCH_MODULES.get(arch)
    if mod_name is None:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    if arch == "llama-1b":
        return mod.LLAMA_1B
    if arch == "llama-300m":
        return mod.LLAMA_300M
    if arch == "llama-7b":
        return mod.LLAMA_7B
    return mod.CONFIG


def get_reduced_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cell_is_runnable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether (arch x shape) is a lowered cell or a documented skip."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, (
            "skip: 524k-token decode requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (DESIGN.md §4)"
        )
    return True, ""


def input_specs(cfg: ModelConfig, shape, dtype=torch.bfloat16, device="meta") -> dict:
    """Stand-ins for every model input of this cell, on `device` (meta: no
    memory). `shape` is a name of SHAPES or a ShapeSpec. Returns {"batch":
    ...} for train/prefill kinds and {"cache": ..., "tokens": ...} for
    decode kinds, as the reference's ShapeDtypeStructs."""
    sp = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    b, s = sp.global_batch, sp.seq_len
    i32 = torch.int32

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device=device)

    if sp.kind in ("train", "prefill"):
        batch: dict = {}
        if cfg.frontend is not None:
            # stubbed modality frontend: precomputed frame/patch embeddings
            batch["embeds"] = sds((b, s, cfg.d_model), dtype)
        else:
            batch["tokens"] = sds((b, s), i32)
        if cfg.attn is not None and cfg.attn.m_rope_sections is not None:
            batch["positions"] = sds((3, b, s), i32)
        if sp.kind == "train":
            batch["labels"] = sds((b, s), i32)
        return {"batch": batch}

    # decode: a cache filled to s tokens plus one new token per sequence
    from repro_torch.models.backbone import init_cache

    out = {"cache": init_cache(cfg, b, s, dtype, device=device), "tokens": sds((b,), i32)}
    if cfg.frontend == "audio_frames":
        out["embeds"] = sds((b, cfg.d_model), dtype)
    return out
