"""The dense family: the llama-style decoder with a SwiGLU FFN (yi-6b)."""
from __future__ import annotations

import torch

from perfbench.families import _decoder
from perfbench.harness.weights import generator, normal

KERNELS = _decoder.KERNELS
FFN = ("w_gate", "w_up", "w_down")


def model_config(cfg: dict):
    import dataclasses
    return dataclasses.replace(_decoder.model_config(cfg, "dense"),
                               d_ff=cfg["intermediate_size"])


def make_weights(cfg: dict, seed: int, device) -> dict:
    gen = generator(seed, device)
    w = _decoder.weights(gen, cfg, device)
    bf16 = getattr(torch, cfg["torch_dtype"])
    L, D, F = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    w["w_gate"] = normal(gen, (L, D, F), D ** -0.5, bf16, device)
    w["w_up"] = normal(gen, (L, D, F), D ** -0.5, bf16, device)
    w["w_down"] = normal(gen, (L, F, D), F ** -0.5, bf16, device)
    return w


def program_params(w: dict, cfg: dict) -> dict:
    return _decoder.program_params(w, cfg, lambda l: {"ffn": {k: w[k][l] for k in FFN}})


def reference_logits(w: dict, cfg: dict, served, judged, quant=None):
    """Each judged request on its own: a dense layer mixes no sequences."""
    return _decoder.reference_logits(w, cfg, list(judged), judged, quant)
