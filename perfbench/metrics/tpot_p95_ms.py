"""Time per output token, 95th percentile (nearest rank) over the requests
due in the window: (last - first token) / (n - 1) over the n tokens each got
by the close. A request with no first token counts as missing; one with a
single token has no gap yet and is left out. The knee sweep reads it; no cell bounds it (its spread at
51 s is over what a bound may allow)."""
from perfbench.harness.stats import due_in_window, tail_ms


def read(run):
    vals = []
    for s in due_in_window(run):
        if s.failed or not s.times:
            vals.append(None)
        elif len(s.times) > 1:
            vals.append((s.times[-1] - s.times[0]) / (len(s.times) - 1))
    return tail_ms(vals, run, 95)
