"""Host milliseconds an engine step takes: the traced window over the steps
in it."""
from perfbench.metrics._shared import step_ms as read  # noqa: F401
