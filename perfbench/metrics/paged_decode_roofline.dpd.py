"""The paged decode kernel's share of its roofline in the dpd cell's pool-B
decode steps: the sum of each call's bound over the sum of its device time
in the trace, in %."""
from perfbench.metrics._shared import decode_roofline as read  # noqa: F401
