"""Spans of the serving step, kept in memory on the profiler's host clock.

    tracing.enable()
    ...                              # engine steps
    spans = tracing.disable()        # [Span]

A span is a context manager around a `with` block, nested by the call
stack. It records its name, its start and end in `time.time_ns()`, its
parent (the index in that list of the span open around it, None for a
root) and a small dict of attributes, set with `.set(key, value)` on the
open span. `time.time_ns()` is the clock torch.profiler stamps its host
events with: a span's
`(start_ns - prof.profiler.kineto_results.trace_start_ns()) / 1e3` lands on
the profile's microsecond timeline, beside the host calls and kernels.
Counts are attributes of the span where the work happens.

While tracing is off (the default) a span site costs one flag test and
returns the shared no-op context: it allocates nothing and formats no
string. While it is on, a recording is columns of ints and names until
disable() turns it into `Span`s: no object the garbage collector tracks
outlives its span (an object kept a span would set the collector off every
few steps, and a full collection stalls the host for up to a second). There
is no exporter, no environment variable and no config field: whoever
enables tracing reads what `disable()` returns.
"""
from __future__ import annotations

import time

_on = False
# this recording, a column entry a span, in start order
_name: list = []
_start: list = []
_end: list = []
_parent: list = []
_attr: list = []        # (span index, key, value) flattened, three entries a set()
_stack: list = []       # indices of the spans open now, innermost last


class Span:
    """One span of a recording, as `disable()` returns it."""
    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs", "index")

    def __init__(self, i: int, attrs):
        self.name, self.start_ns, self.end_ns = _name[i], _start[i], _end[i]
        self.parent, self.attrs, self.index = _parent[i], attrs, i


class _Open(int):
    """An open span: its index in the recording."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # closes nothing once disable() has taken the recording
        if _stack and _stack[-1] == self:
            _end[self] = time.time_ns()
            _stack.pop()
        return False

    def set(self, key: str, value) -> None:
        _attr.extend((int(self), key, value))


class _Off:
    """The shared context every span site returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key: str, value) -> None:
        pass


NOOP = _Off()
_COLUMNS = (_name, _start, _end, _parent, _attr, _stack)


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start a recording (dropping anything left of an earlier one)."""
    global _on
    for c in _COLUMNS:
        c.clear()
    _on = True


def disable() -> list:
    """Stop recording; the spans recorded since enable(). A span still open
    has end_ns None."""
    global _on
    _on = False
    attrs: dict = {}
    for j in range(0, len(_attr), 3):
        attrs.setdefault(_attr[j], {})[_attr[j + 1]] = _attr[j + 2]
    out = [Span(i, attrs.get(i)) for i in range(len(_name))]
    for c in _COLUMNS:
        c.clear()
    return out


def span(name: str):
    """A span around a `with` block; NOOP while tracing is off."""
    if not _on:
        return NOOP
    i = len(_name)
    _name.append(name)
    _parent.append(_stack[-1] if _stack else None)
    _end.append(None)
    _stack.append(i)
    _start.append(time.time_ns())
    return _Open(i)
