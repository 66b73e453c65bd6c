"""The paged prefill kernel's share of its roofline: the sum of each chunk's
bound over the sum of its device time in the trace, in %."""
from perfbench.metrics._shared import prefill_roofline as read  # noqa: F401
