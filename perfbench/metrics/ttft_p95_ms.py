"""Time to first token, 95th percentile (nearest rank) over every request due
in the window, from its due time, on the host clock; a request with no first
token by the close counts as missing. The knee sweep reads it; no cell
bounds it (its spread at 51 s is over what a bound may allow)."""
from perfbench.harness.stats import due_in_window, tail_ms


def read(run):
    reqs = due_in_window(run)
    return tail_ms([s.times[0] - s.due_s if s.times and not s.failed else None
                    for s in reqs], run, 95)
