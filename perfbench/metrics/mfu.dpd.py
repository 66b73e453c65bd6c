"""Model FLOPs of the dpd cell's untraced steps over their host time at
the card's bf16 peak (989e12 FLOP/s), in %: the whole step's share of the
peak beside its kernels' rooflines."""
from perfbench.metrics._shared import mfu as read  # noqa: F401
