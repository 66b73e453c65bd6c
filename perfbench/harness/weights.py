"""Weights from the seed, made on the card by the benchmark.

One stacked tensor a kind of weight (all layers of it together), filled on
the device by a `torch.Generator` seeded with the run's seed, in the type the
model is served in: bf16 projections, fp32 norm gains and router (as the
program keeps them). `program_params` hands the program views of these
tensors in its parameter layout; the plain reference reads the same tensors.
"""
from __future__ import annotations

import torch

SEED_MOD = 2 ** 63


def _normal(gen, shape, std, dtype, device, mean=0.0):
    t = torch.empty(shape, dtype=dtype, device=device)
    for piece in (t if t.dim() >= 3 else [t]):       # one call a layer
        piece.normal_(mean, std, generator=gen)
    return t


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{kind: stacked tensor} for a config file's sizes (family dense or moe)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    bf16, f32 = getattr(torch, cfg["torch_dtype"]), torch.float32
    L, D, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    H, KV, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    w = {
        "embed": _normal(gen, (V, D), 0.02, bf16, device),
        "lm_head": _normal(gen, (V, D), D ** -0.5, bf16, device),
        "final_norm": _normal(gen, (D,), 0.1, f32, device, mean=1.0),
        "norm1": _normal(gen, (L, D), 0.1, f32, device, mean=1.0),
        "norm2": _normal(gen, (L, D), 0.1, f32, device, mean=1.0),
        "wq": _normal(gen, (L, D, H * Dh), D ** -0.5, bf16, device),
        "wk": _normal(gen, (L, D, KV * Dh), D ** -0.5, bf16, device),
        "wv": _normal(gen, (L, D, KV * Dh), D ** -0.5, bf16, device),
        "wo": _normal(gen, (L, H * Dh, D), (H * Dh) ** -0.5, bf16, device),
    }
    if cfg["family"] == "dense":
        F = cfg["intermediate_size"]
        w["w_gate"] = _normal(gen, (L, D, F), D ** -0.5, bf16, device)
        w["w_up"] = _normal(gen, (L, D, F), D ** -0.5, bf16, device)
        w["w_down"] = _normal(gen, (L, F, D), F ** -0.5, bf16, device)
    elif cfg["family"] == "moe":
        E, Fe, Fs = cfg["num_experts"], cfg["moe_intermediate_size"], \
            cfg["shared_expert_intermediate_size"]
        w["router"] = _normal(gen, (L, D, E), D ** -0.5, f32, device)
        w["e_gate"] = _normal(gen, (L, E, D, Fe), D ** -0.5, bf16, device)
        w["e_up"] = _normal(gen, (L, E, D, Fe), D ** -0.5, bf16, device)
        w["e_down"] = _normal(gen, (L, E, Fe, D), Fe ** -0.5, bf16, device)
        w["s_gate"] = _normal(gen, (L, D, Fs), D ** -0.5, bf16, device)
        w["s_up"] = _normal(gen, (L, D, Fs), D ** -0.5, bf16, device)
        w["s_down"] = _normal(gen, (L, Fs, D), Fs ** -0.5, bf16, device)
    else:
        raise ValueError(f"family {cfg['family']!r} has no weights here")
    return w


def program_params(w: dict, cfg: dict) -> dict:
    """The program's parameter tree (repro_torch.models.backbone), as views of w."""
    layers = []
    for l in range(cfg["num_hidden_layers"]):
        lp = {"norm1": w["norm1"][l], "norm2": w["norm2"][l],
              "attn": {k: w[k][l] for k in ("wq", "wk", "wv", "wo")}}
        if cfg["family"] == "dense":
            lp["ffn"] = {k: w[k][l] for k in ("w_gate", "w_up", "w_down")}
        else:
            lp["moe"] = {"router": w["router"][l], "w_gate": w["e_gate"][l],
                         "w_up": w["e_up"][l], "w_down": w["e_down"][l],
                         "shared": {"w_gate": w["s_gate"][l], "w_up": w["s_up"][l],
                                    "w_down": w["s_down"][l]}}
        layers.append(lp)
    return {"tok": {"embed": w["embed"], "lm_head": w["lm_head"]},
            "layers": layers, "final_norm": w["final_norm"]}

