"""Model FLOPs of the traced steps over their host time at the card's bf16
peak (989e12 FLOP/s), in %."""
from perfbench.metrics._shared import mfu as read  # noqa: F401
