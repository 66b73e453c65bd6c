"""The moe family: the llama-style decoder with routed experts and a shared
expert, ungated (qwen2-moe-a2.7b), in the program's variant that the
configuration file's `departures` describe.

The reference also needs the program's dispatch groups: which tokens went
through the experts together, in what order. That is the run's schedule,
read off the host timeline of tokens: a prompt's tokens are one group (the
engine recomputes the whole prompt in one pass when its last chunk runs),
and each decode step's group is every sequence that got a token in that
step, in the order the scheduler keeps its running list (by the step of the
first token, then by submission). The reference then replays every token
the engine served in the window, layer by layer.
"""
from __future__ import annotations

import functools

import torch

from perfbench.families import _decoder
from perfbench.harness import check
from perfbench.harness.weights import generator, normal
from perfbench.reference import model as ref

KERNELS = _decoder.KERNELS


class ScheduleError(check.JudgeError):
    """The token timeline does not fit the schedule the groups assume."""


def model_config(cfg: dict):
    import dataclasses
    out = _decoder.model_config(cfg, "moe")
    moe = dataclasses.replace(out.moe, num_experts=cfg["num_experts"],
                              top_k=cfg["num_experts_per_tok"],
                              d_ff_expert=cfg["moe_intermediate_size"],
                              d_ff_shared=cfg["shared_expert_intermediate_size"],
                              capacity_factor=float(cfg["capacity_factor"]))
    return dataclasses.replace(out, d_ff=cfg["moe_intermediate_size"], moe=moe)


def make_weights(cfg: dict, seed: int, device) -> dict:
    gen = generator(seed, device)
    w = _decoder.weights(gen, cfg, device)
    bf16, f32 = getattr(torch, cfg["torch_dtype"]), torch.float32
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    E, Fe, Fs = cfg["num_experts"], cfg["moe_intermediate_size"], \
        cfg["shared_expert_intermediate_size"]
    w["router"] = normal(gen, (L, D, E), D ** -0.5, f32, device)
    w["e_gate"] = normal(gen, (L, E, D, Fe), D ** -0.5, bf16, device)
    w["e_up"] = normal(gen, (L, E, D, Fe), D ** -0.5, bf16, device)
    w["e_down"] = normal(gen, (L, E, Fe, D), Fe ** -0.5, bf16, device)
    w["s_gate"] = normal(gen, (L, D, Fs), D ** -0.5, bf16, device)
    w["s_up"] = normal(gen, (L, D, Fs), D ** -0.5, bf16, device)
    w["s_down"] = normal(gen, (L, Fs, D), Fs ** -0.5, bf16, device)
    return w


def program_params(w: dict, cfg: dict) -> dict:
    return _decoder.program_params(w, cfg, lambda l: {"moe": {
        "router": w["router"][l], "w_gate": w["e_gate"][l], "w_up": w["e_up"][l],
        "w_down": w["e_down"][l],
        "shared": {"w_gate": w["s_gate"][l], "w_up": w["s_up"][l], "w_down": w["s_down"][l]}}})


def moe_groups(seqs) -> list:
    """[(sequence index, positions)] groups in dispatch order (see above)."""
    groups = []
    by_step: dict[int, list] = {}
    for i, s in enumerate(seqs):
        p = len(s.prompt)
        groups.append([(i, torch.arange(p))])
        st = s.steps[:len(s.times)]
        for j in range(1, len(st)):
            if st[j] != st[j - 1] + 1:
                raise ScheduleError(f"request {s.idx} skipped a decode step ({st[j - 1]} -> "
                                    f"{st[j]}): the decode groups cannot be rebuilt")
            by_step.setdefault(st[j], []).append(((st[0], s.engine_req.req_id), i, p + j - 1))
    for step in sorted(by_step):
        members = sorted(by_step[step])
        groups.append([(i, torch.tensor([pos])) for _, i, pos in members])
    return groups


def reference_logits(w: dict, cfg: dict, served, judged, quant=None):
    """Every request that got a token, in its dispatch groups: a token's
    experts depend on which tokens shared its group."""
    seqs = [s for s in served if s.times]
    flat = ref.flat_groups(moe_groups(seqs), [int(check.fed(s).numel()) for s in seqs],
                           w["embed"].device)
    ffn = functools.partial(ref.moe, cfg=cfg, groups=flat)
    return _decoder.reference_logits(w, cfg, seqs, judged, quant, ffn)
