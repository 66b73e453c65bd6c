"""Exact equality between an object of the port and one of the reference.

The two packages define the same classes twice, so a port's `SimResult`
never `==` a reference one. `assert_same` walks both objects together:
dataclasses and plain objects field by field (their class names must
match), dicts key by key in order, sequences item by item, numpy arrays
element by element, and every leaf with `==` (NaN equals NaN). It fails at
the first difference and names its path.
"""
import dataclasses
import math

import numpy as np


def _fields(x) -> dict:
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return dict(vars(x))


def _plain(x):
    """A hashable plain value of `x`, for comparing dict keys."""
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple((k, _plain(v)) for k, v in _fields(x).items())
    return x


def assert_same(got, want, path: str = "result") -> None:
    if isinstance(want, float) and isinstance(got, float) and math.isnan(want):
        assert math.isnan(got), (path, got, want)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f"), path
    elif isinstance(want, dict):
        assert isinstance(got, dict), (path, type(got))
        assert [_plain(k) for k in got] == [_plain(k) for k in want], path
        for (k, g), w in zip(got.items(), want.values()):
            assert_same(g, w, f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got).__name__ == type(want).__name__, (path, type(got), type(want))
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif dataclasses.is_dataclass(want) or hasattr(want, "__dict__"):
        assert type(got).__name__ == type(want).__name__, (path, type(got), type(want))
        gf, wf = _fields(got), _fields(want)
        assert list(gf) == list(wf), path
        for k, w in wf.items():
            assert_same(gf[k], w, f"{path}.{k}")
    else:
        assert type(got) is type(want) and got == want, (path, got, want)
