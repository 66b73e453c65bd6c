"""The paged prefill kernel's share of its roofline in the dpd cell's pool-A
prefill steps: the sum of each chunk's bound over the sum of its device
time in the trace, in %."""
from perfbench.metrics._shared import prefill_roofline as read  # noqa: F401
