"""Output tokens an engine step emits, over the traced steps: the decode
batch the scheduler keeps (plus the first tokens of finished prefills)."""
from perfbench.metrics._shared import decode_batch as read  # noqa: F401
