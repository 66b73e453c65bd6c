"""Tails, counts and spreads over a run's requests."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it. math.inf sorts last."""
    if not values:
        raise ValueError("percentile of nothing")
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def due_in_window(run):
    """The requests due in the window (from the traffic's lead-in to its
    close): what a tail is over."""
    return [s for s in run.requests if run.t_due0 <= s.due_s < run.t_close]


def tail_ms(values, run, q: float) -> float | None:
    """q-th percentile in ms of values in seconds; None marks a missing
    request, which counts as infinitely late. Where the tail itself is
    missing, the metric reads the window's length, the longest wait a run
    can see."""
    if not values:
        return None
    p = percentile([math.inf if v is None else v for v in values], q)
    return 1e3 * (p if math.isfinite(p) else run.t_end - run.t_open)


def tokens_in_window(run) -> int:
    return sum(1 for s in run.requests for t in s.times if run.t_open <= t <= run.t_end)

