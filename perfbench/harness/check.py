"""Whether what the timed path served is right: the plain reference
(perfbench/reference, through the cell's family module, perfbench/families)
run over a sample of the requests the window finished, on their prompts and
the tokens the engine served.

Serving is greedy, so each served token should be the reference's best at
its position. A served token's gap is the reference's best logit there less
the served token's; a cell's `checks` compare the widest (`max_gap`) or the
mean (`mean_gap`) over the judged tokens.
"""
from __future__ import annotations

import numpy as np
import torch


class JudgeError(RuntimeError):
    """The run cannot be judged: a family's reference cannot be rebuilt
    from what was served (its `reference_logits` raises it)."""


def sample(served, seed: int, k: int):
    """The finished requests to judge: the one with the most output tokens,
    then k - 1 drawn from the seed."""
    done = [s for s in served if s.finished and not s.failed]
    if not done:
        return []
    longest = max(done, key=lambda s: (s.output_len, -s.idx))
    rest = [s for s in done if s is not longest]
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x5A3B1E])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def fed(s) -> torch.Tensor:
    """Prompt and served tokens but the last: what the engine fed."""
    toks = s.tokens[:len(s.times)]
    return torch.from_numpy(np.concatenate([s.prompt, np.asarray(toks[:-1], np.int32)]).astype(
        np.int64))


def gaps(logits: list, targets: list) -> torch.Tensor:
    """Per position: the reference's best logit minus the target token's."""
    out = []
    for lg, t in zip(logits, targets):
        t = torch.as_tensor(t, dtype=torch.long, device=lg.device)
        out.append(lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0])
    return torch.cat(out)


def readings(g: torch.Tensor, prefix: str = "") -> dict:
    """The widest and the mean of per-token gaps g, and the share that are 0."""
    return {f"{prefix}max_gap": float(g.max()), f"{prefix}mean_gap": float(g.mean()),
            f"{prefix}agree": float((g == 0).float().mean())}


def judge(family, w: dict, cfg: dict, served, judged, control: bool = False) -> dict:
    """Readings of the program's served tokens, judged by the reference of
    `family` (the cell's family module); with control=True also the
    control's: the reference in fp8 at the same positions, its own first
    choice judged by the fp32 reference."""
    want = family.reference_logits(w, cfg, served, judged)
    targets = [s.tokens[:len(s.times)] for s in judged]
    g = gaps(want, targets)
    out = dict(readings(g), tokens=int(g.numel()))
    if control:
        low = family.reference_logits(w, cfg, served, judged, quant="fp8")
        out.update(readings(gaps(want, [lg.argmax(-1) for lg in low]), "control_"))
    return out
