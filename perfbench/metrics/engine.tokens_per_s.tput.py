"""Output tokens a host second of engine steps emits: the observed steps
outside the profiled span, end to end (the offline cell's throughput, read
per layer beside its step time and batch)."""
from perfbench.metrics._shared import tokens_per_s as read  # noqa: F401
