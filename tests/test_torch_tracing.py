"""repro_torch.tracing: the spans of the continuous serving step on reduced
yi-6b and qwen2-moe engines (CPU), their nesting and counts, greedy tokens
the same with spans on and off, what a span site costs while tracing is
off, and the clock the spans share with torch.profiler (on the CPU, and
around a kernel launch on the card: marker `cuda`)."""
import functools
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_reduced_config
from repro_torch.models import backbone
from repro_torch.serving.batching import BatchPolicy
from repro_torch.serving.engine import ServingEngine

ARCHS = ["yi-6b", "qwen2-moe-a2.7b"]
PROMPTS = (5, 19, 33)
NEW_TOKENS = 4


@functools.lru_cache(maxsize=None)
def model(arch: str):
    cfg = get_reduced_config(arch, num_layers=2)
    return cfg, backbone.init_params(torch.Generator().manual_seed(0), cfg)


@functools.lru_cache(maxsize=None)
def serve(arch: str, traced: bool):
    """({req_id: greedy tokens}, spans) of three ragged requests through a
    continuous paged engine; spans are recorded only when `traced`."""
    cfg, params = model(arch)
    eng = ServingEngine(cfg, params, temperature=0.0, seed=0, max_batch=4, pool_blocks=64,
                        block_size=8, batching=BatchPolicy(kind="continuous", chunk_tokens=16,
                                                           block_size=8), device="cpu")
    rng = np.random.default_rng(3)
    if traced:
        tracing.enable()
    try:
        for i, n in enumerate(PROMPTS):
            eng.submit(rng.integers(1, 400, size=n).astype(np.int32), NEW_TOKENS,
                       arrival_s=0.05 * i)
        done = eng.run_until_idle()
    finally:
        spans = tracing.disable()
    return {r.req_id: list(r.out_tokens) for r in done}, tuple(spans)


def children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


def inside(spans, root):
    """Every nested span under `root`."""
    out, todo = [], [root.index]
    while todo:
        i = todo.pop()
        kids = [s for s in spans if s.parent == i]
        out += kids
        todo += [k.index for k in kids]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_off_records_nothing_and_tokens_match(arch):
    assert tracing.span("engine.step") is tracing.NOOP and not tracing.enabled()
    off, spans = serve(arch, False)
    assert spans == ()
    on, spans = serve(arch, True)
    assert on == off and len(on) == len(PROMPTS)
    assert all(len(t) == NEW_TOKENS for t in on.values())
    assert spans and all(s.end_ns is not None and s.end_ns >= s.start_ns for s in spans)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_step_nests_plan_forwards_and_syncs(arch):
    cfg, _ = model(arch)
    _, spans = serve(arch, True)
    steps = [s for s in spans if s.name == "engine.step" and s.attrs]
    assert steps and all(s.parent is None for s in steps)
    assert sum(s.attrs["chunks"] for s in steps) >= len(PROMPTS)
    ffn = "model.moe" if cfg.family == "moe" else "model.ffn"
    for st in steps:
        a = st.attrs
        kids = children(spans, st)
        assert kids[0].name == "engine.plan"
        assert {k.name for k in kids} <= {"engine.plan", "engine.prefill", "engine.decode",
                                          "engine.sync"}
        assert sum(k.name == "engine.prefill" for k in kids) == a["chunks"]
        assert sum(k.name == "engine.decode" for k in kids) == (a["decodes"] > 0)
        under = inside(spans, st)
        fwd = [s for s in under if s.name == "model.forward"]
        assert len(fwd) == a["chunks"] + (a["decodes"] > 0)
        assert all(spans[f.parent].name in ("engine.prefill", "engine.decode") for f in fwd)
        for f in fwd:
            layers = children(spans, f)
            assert [s.name for s in layers] == ["model.attn", ffn] * cfg.num_layers
            assert all(f.start_ns <= s.start_ns <= s.end_ns <= f.end_ns for s in layers)
        syncs = [s for s in under if s.name == "engine.sync"]
        # one sync a decode, one a prefill chunk that ends its prompt
        assert (a["decodes"] > 0) <= len(syncs) <= a["chunks"] + (a["decodes"] > 0)
        assert all(spans[s.parent].name in ("engine.step", "engine.prefill") for s in syncs)
        assert all(st.start_ns <= s.start_ns <= s.end_ns <= st.end_ns for s in under)


def test_a_recording_keeps_no_object_the_collector_tracks():
    """Spans kept until disable() would set the garbage collector off every
    few steps of a traced window; a recording is columns of ints and names."""
    import gc
    gc.disable()
    try:
        tracing.enable()
        c0 = gc.get_count()[0]
        for i in range(2000):
            with tracing.span("engine.step") as st:
                with tracing.span("model.forward"):
                    pass
                st.set("chunks", i)
        grown = gc.get_count()[0] - c0
        spans = tracing.disable()
    finally:
        gc.enable()
    assert len(spans) == 4000 and grown < 100
    assert spans[-2].attrs == {"chunks": 1999} and spans[-1].attrs is None
    assert spans[-1].parent == spans[-2].index


def test_a_site_allocates_nothing_while_off():
    tracemalloc.start()
    try:
        for _ in range(1000):
            with tracing.span("model.attn") as sp:
                sp.set("chunks", 1)
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, tracing.__file__)])
    finally:
        tracemalloc.stop()
    assert not tracing.enabled() and snap.statistics("lineno") == []


def test_an_exception_closes_its_spans():
    tracing.enable()
    try:
        with pytest.raises(ValueError):
            with tracing.span("engine.step"):
                with tracing.span("engine.plan"):
                    raise ValueError
        with tracing.span("engine.step"):
            pass
    finally:
        spans = tracing.disable()
    assert [(s.name, s.parent) for s in spans] == [("engine.step", None), ("engine.plan", 0),
                                                  ("engine.step", None)]
    assert all(s.end_ns is not None for s in spans)


def test_enable_starts_afresh_and_an_open_span_has_no_end():
    tracing.enable()
    tracing.span("engine.step").__enter__()       # left open
    tracing.enable()
    assert tracing.disable() == []
    tracing.enable()
    with tracing.span("engine.step"):
        tracing.span("engine.decode").__enter__()
        spans = tracing.disable()
    assert [(s.name, s.parent, s.end_ns) for s in spans] == [("engine.step", None, None),
                                                             ("engine.decode", 0, None)]
    assert tracing.span("engine.step") is tracing.NOOP


def test_a_span_encloses_its_profiler_event():
    """time.time_ns() less the profile's trace_start_ns lands on the
    profiler's microsecond timeline: a span around torch.mm holds aten::mm."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(128, 128)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    tracing.enable()
    for _ in range(3):
        with tracing.span("mm"):
            torch.mm(a, a)
        time.sleep(1e-3)
    spans = tracing.disable()
    prof.stop()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    mm = [e.time_range for e in prof.events() if e.name == "aten::mm"]
    assert len(mm) == len(spans) == 3
    for s, tr in zip(spans, mm):
        assert (s.start_ns - t0) / 1e3 <= tr.start <= tr.end <= (s.end_ns - t0) / 1e3


@pytest.mark.cuda
def test_a_span_encloses_its_kernel_launch_on_the_card():
    """On the card's profile (CUDA activity only), each span around one
    kernel launch holds exactly that launch's cudaLaunchKernel, and the
    kernel shares the launch's correlation id."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the launch and its kernel are the card's")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(1 << 20, device="cuda")
    x.mul_(1.0)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    tracing.enable()
    for _ in range(20):
        with tracing.span("launch"):
            x.mul_(1.0001)
        torch.cuda.synchronize()
    spans = tracing.disable()
    prof.stop()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    calls = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("cudaLaunchKernel"))
    margins = []
    for s in spans:
        a, b = (s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3
        held = [c for c in calls if a <= c[0] and c[1] <= b]
        assert len(held) == 1, (a, b, calls)
        margins.append((held[0][0] - a, b - held[0][1]))
    print("margin us before, after: least", min(m[0] for m in margins), min(m[1] for m in margins),
          "most", max(m[0] for m in margins), max(m[1] for m in margins))
    raw = prof.profiler.kineto_results.events()
    host = {e.correlation_id() for e in raw if e.device_type() != DeviceType.CUDA}
    kernels = [e for e in raw if e.device_type() == DeviceType.CUDA]
    assert len(kernels) >= len(spans) and all(e.correlation_id() in host for e in kernels)
