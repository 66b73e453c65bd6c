"""The arithmetic the per-layer readers share: each reader file names one
metric and calls one of these on the traced run."""
from __future__ import annotations

from perfbench.harness.trace import launches_of
from perfbench.metrics import counts

DECODE_KERNEL = "paged_decode_kernel"
PREFILL_KERNEL = "paged_prefill"


def traced(run):
    """The steps inside the profiled span."""
    h0, h1 = run.traced
    return [o for o in run.obs if o.t0 >= h0 and o.t1 <= h1]


def untraced(run):
    """The observed steps outside the profiled span, whose host time the
    profiler did not slow: (steps, their host seconds end to end)."""
    h0, h1 = run.traced
    before = [o for o in run.obs if o.t1 <= h0]
    after = [o for o in run.obs if o.t0 >= h1]
    parts = [p for p in (before, after) if p]
    return [o for p in parts for o in p], sum(p[-1].t1 - p[0].t0 for p in parts)


def step_ms(run):
    steps, secs = untraced(run)
    return 1e3 * secs / len(steps) if steps else None


def tokens_per_s(run):
    """Output tokens over the untraced steps' host seconds."""
    steps, secs = untraced(run)
    return sum(o.tokens_out for o in steps) / secs if steps and secs > 0 else None


def decode_batch(run):
    steps, _ = untraced(run)
    return sum(o.tokens_out for o in steps) / len(steps) if steps else None


def mfu(run):
    steps, secs = untraced(run)
    if not steps:
        return None
    flops = sum(counts.step_flops(o, run.cfg) for o in steps)
    return 100.0 * flops / (secs * counts.PEAK_FLOPS)


def idle_share(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def decode_roofline(run):
    """Sum of each call's bound over the kernel's device time. Nothing when
    the path did not launch the kernel, or the trace holds another number of
    launches than the steps made (one a layer a decode step)."""
    calls = [o.decode_ctx for o in traced(run) if o.decode_ctx]
    n, secs = launches_of(run.trace, DECODE_KERNEL)
    layers = run.cfg["num_hidden_layers"]
    if not calls or n == 0 or n != layers * len(calls) or run.launches.get("decode") != n:
        return None
    bound = layers * sum(counts.bound_s(*counts.paged_decode_call(c, run.cfg)) for c in calls)
    return 100.0 * bound / secs


def prefill_roofline(run):
    chunks = [c for o in traced(run) for c in o.chunks]
    n, secs = launches_of(run.trace, PREFILL_KERNEL)
    layers = run.cfg["num_hidden_layers"]
    if not chunks or n == 0 or n != layers * len(chunks) or run.launches.get("prefill") != n:
        return None
    bound = layers * sum(counts.bound_s(*counts.paged_prefill_call(c, t, run.cfg))
                         for c, t in chunks)
    return 100.0 * bound / secs
