"""The one traffic generator: it reads a mix file (`traffic/<mix>.json`) and
the cell's rate, and draws requests from the seed.

The sizes are GreenLLM's Table 2 (the paper's datasets, as in the program's
`serving/workload.py` `DATASETS`): a 3-point mixture of the dataset's
P25/P50/P75 (prompt, output) token pairs, weighted as the mix says
(`sample_mixture_requests`). Arrivals are Poisson at the cell's rate, or a
backlog that is all due when the window opens.

Every seed gets the same multiset of sizes and of inter-arrival gaps, in
another order: the sizes hold the mixture's exact proportions over the whole
run, and the gaps are the exponential distribution's quantiles at
(i + 1/2) / n; each list is shuffled whole. So each gap is exponential and
each size a draw of the mixture, and any span of k arrivals out of the run's
n is as bursty as Poisson's but for the factor (n - k) / (n - 1) on its
variance (sampling without replacement); only the run's totals are fixed.
The seed changes which request comes when, not how much work a run holds.
Prompt token ids are uniform over the vocabulary.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

ARRIVALS = ("poisson", "backlog")


@dataclasses.dataclass(frozen=True)
class Req:
    idx: int
    due_s: float             # seconds after the traffic starts
    prompt: np.ndarray       # (prompt_len,) int32
    output_len: int


def _block(weights: list[float], limit: int = 64) -> list[int]:
    """The smallest block of requests that holds each size point an exact
    whole number of times in the mixture's proportions."""
    total = sum(weights)
    p = [w / total for w in weights]
    for n in range(1, limit + 1):
        counts = [round(x * n) for x in p]
        if sum(counts) == n and all(abs(c - x * n) < 1e-9 for c, x in zip(counts, p)):
            return counts
    raise ValueError(f"mixture weights {weights} need a block of more than {limit}")


def sizes(mix: dict, n: int, rng: np.random.Generator) -> list[tuple[int, int]]:
    """n (prompt, output) pairs (n a multiple of the mixture's block) in the
    mixture's exact proportions, shuffled whole."""
    points = [tuple(mix[p]) for p in ("p25", "p50", "p75")]
    counts = _block(mix["weights"])
    if n % sum(counts):
        raise ValueError(f"{n} requests do not hold the mixture {counts} whole")
    pairs = [pt for pt, c in zip(points, counts) for _ in range(c * n // sum(counts))]
    return [pairs[i] for i in rng.permutation(n)]


def gaps(n: int, rate: float, rng: np.random.Generator) -> np.ndarray:
    """n inter-arrival gaps at `rate`: the exponential distribution's
    quantiles at (i + 1/2) / n, shuffled whole."""
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(-np.log1p(-q) / rate)


def generate(mix: dict, seed: int, vocab: int, horizon_s: float = 0.0,
             rate: float = 0.0) -> list[Req]:
    """The requests of one run. Poisson: rate x horizon_s requests, rounded
    up to hold the mixture whole, the first one gap after 0. Backlog:
    mix["backlog"] requests, all due at 0."""
    if mix["arrivals"] not in ARRIVALS:
        raise ValueError(f"arrivals must be one of {ARRIVALS}: {mix['arrivals']!r}")
    rng = np.random.default_rng(seed)
    if mix["arrivals"] == "poisson":
        if rate <= 0 or horizon_s <= 0:
            raise ValueError(f"poisson traffic needs a rate and a horizon: {rate}, {horizon_s}")
        block = sum(_block(mix["weights"]))
        n = block * max(1, math.ceil(rate * horizon_s / block))
        due = np.cumsum(gaps(n, rate, rng))
    else:
        n = int(mix["backlog"])
        due = np.zeros(n)
    pairs = sizes(mix, n, rng)
    ids = rng.integers(0, vocab, size=sum(p for p, _ in pairs), dtype=np.int64)
    reqs, at = [], 0
    for i, ((plen, olen), t) in enumerate(zip(pairs, due)):
        reqs.append(Req(i, float(t), ids[at:at + plen].astype(np.int32), int(olen)))
        at += plen
    return reqs


def mean_output(mix: dict) -> float:
    counts = _block(mix["weights"])
    pts = [mix[p][1] for p in ("p25", "p50", "p75")]
    return sum(c * o for c, o in zip(counts, pts)) / sum(counts)
