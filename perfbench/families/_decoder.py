"""What the dense and moe families share: the llama-style decoder around
their FFN (embedding, RMSNorms, GQA attention with RoPE, head) in the
program's ModelConfig, in the weights and the program's parameter tree, and
the plain reference's logits at the judged positions."""
from __future__ import annotations

import dataclasses

import torch

from perfbench.harness import check
from perfbench.harness.weights import normal
from perfbench.reference import model as ref

# both families' serving paths: paged decode, and paged prefill (dense) or
# flash (the moe prefill's recompute)
KERNELS = ("flash_attention", "paged_decode_attention", "paged_prefill_attention")


def model_config(cfg: dict, family: str):
    """The program's ModelConfig of cfg["arch"] with the file's depth, width,
    vocabulary, norm, type and attention; the FFN's sizes are the caller's.
    The arch has to be of the program's `family`."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch"])
    if base.family != family:
        raise ValueError(f"{cfg['arch']} is family {base.family}, this module serves {family}")
    attn = dataclasses.replace(base.attn, num_heads=cfg["num_attention_heads"],
                               num_kv_heads=cfg["num_key_value_heads"],
                               head_dim=cfg["head_dim"], rope_theta=float(cfg["rope_theta"]))
    return dataclasses.replace(base, num_layers=cfg["num_hidden_layers"],
                               d_model=cfg["hidden_size"], vocab_size=cfg["vocab_size"],
                               norm_eps=float(cfg["rms_norm_eps"]),
                               tie_embeddings=cfg["tie_word_embeddings"],
                               dtype=cfg["torch_dtype"], attn=attn)


def weights(gen: torch.Generator, cfg: dict, device) -> dict:
    """The decoder's weights but the FFN's, drawn first, in this order."""
    bf16, f32 = getattr(torch, cfg["torch_dtype"]), torch.float32
    L, D, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    H, KV, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    return {
        "embed": normal(gen, (V, D), 0.02, bf16, device),
        "lm_head": normal(gen, (V, D), D ** -0.5, bf16, device),
        "final_norm": normal(gen, (D,), 0.1, f32, device, mean=1.0),
        "norm1": normal(gen, (L, D), 0.1, f32, device, mean=1.0),
        "norm2": normal(gen, (L, D), 0.1, f32, device, mean=1.0),
        "wq": normal(gen, (L, D, H * Dh), D ** -0.5, bf16, device),
        "wk": normal(gen, (L, D, KV * Dh), D ** -0.5, bf16, device),
        "wv": normal(gen, (L, D, KV * Dh), D ** -0.5, bf16, device),
        "wo": normal(gen, (L, H * Dh, D), (H * Dh) ** -0.5, bf16, device),
    }


def program_params(w: dict, cfg: dict, ffn) -> dict:
    """The program's parameter tree (repro_torch.models.backbone), as views
    of w; `ffn(l)` gives layer l's FFN entries."""
    layers = []
    for l in range(cfg["num_hidden_layers"]):
        lp = {"norm1": w["norm1"][l], "norm2": w["norm2"][l],
              "attn": {k: w[k][l] for k in ("wq", "wk", "wv", "wo")}}
        lp.update(ffn(l))
        layers.append(lp)
    return {"tok": {"embed": w["embed"], "lm_head": w["lm_head"]},
            "layers": layers, "final_norm": w["final_norm"]}


def reference_logits(w: dict, cfg: dict, seqs, judged, quant=None, ffn=ref.swiglu):
    """The reference run over what the engine fed each of `seqs` (the
    judged requests among them): fp32 logits at each judged request's
    served positions, in the order of `judged`."""
    at = {id(s): i for i, s in enumerate(seqs)}
    rows = [torch.zeros(0, dtype=torch.long) for _ in seqs]
    for s in judged:
        p = len(s.prompt)
        rows[at[id(s)]] = torch.arange(p - 1, p - 1 + len(s.times))
    out = ref.logits(w, cfg, [check.fed(s) for s in seqs], rows, ffn, quant)
    return [out[at[id(s)]] for s in judged]
