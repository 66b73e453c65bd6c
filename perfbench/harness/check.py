"""Whether what the timed path served is right: the plain reference
(perfbench/reference/model.py) run over a sample of the requests the window
finished, on their prompts and the tokens the engine served.

Serving is greedy, so each served token should be the reference's best at
its position. A served token's gap is the reference's best logit there less
the served token's; a cell's `checks` compare the widest (`max_gap`) or the
mean (`mean_gap`) over the judged tokens.

For the moe family the reference also needs the program's dispatch groups:
which tokens went through the experts together, in what order. That is the
run's schedule, read off the host timeline of tokens: a prompt's tokens are
one group (the engine recomputes the whole prompt in one pass when its last
chunk runs), and each decode step's group is every sequence that got a token
in that step, in the order the scheduler keeps its running list (by the step
of the first token, then by submission). The reference then replays every
token the engine served in the window, layer by layer.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as ref


class ScheduleError(RuntimeError):
    """The token timeline does not fit the schedule the groups assume."""


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


def served_logits(w: dict, cfg: dict, served, judged, quant=None):
    """Reference logits at each judged request's served positions, fp32."""
    if cfg["family"] == "moe":
        seqs = [s for s in served if s.times]
        at = {id(s): i for i, s in enumerate(seqs)}
        groups = moe_groups(seqs)
    else:
        seqs, at, groups = list(judged), {id(s): i for i, s in enumerate(judged)}, None
    rows = [torch.zeros(0, dtype=torch.long) for _ in seqs]
    for s in judged:
        p = len(s.prompt)
        rows[at[id(s)]] = torch.arange(p - 1, p - 1 + len(s.times))
    out = ref.logits(w, cfg, [fed(s) for s in seqs], rows, groups, quant)
    return [out[at[id(s)]] for s in judged]


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


def judge(w: dict, cfg: dict, served, judged, control: bool = False) -> dict:
    """Readings of the program's served tokens; with control=True also the
    control's: the reference in fp8 at the same positions, its own first
    choice judged by the fp32 reference."""
    want = served_logits(w, cfg, served, judged)
    targets = [s.tokens[:len(s.times)] for s in judged]
    g = gaps(want, targets)
    out = dict(readings(g), tokens=int(g.numel()))
    if control:
        low = served_logits(w, cfg, served, judged, quant="fp8")
        out.update(readings(gaps(want, [lg.argmax(-1) for lg in low]), "control_"))
    return out
