"""Share of the dpd cell's traced window in which nothing ran on the card,
in %."""
from perfbench.metrics._shared import idle_share as read  # noqa: F401
