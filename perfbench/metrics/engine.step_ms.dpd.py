"""Host milliseconds an engine step takes in the dpd cell (a prefill step
of pool A or a decode step of pool B): the untraced steps over their
host seconds."""
from perfbench.metrics._shared import step_ms as read  # noqa: F401
