"""The end-to-end and per-layer arithmetic on synthetic runs, and the
operation and byte counts against hand-worked cases."""
import math
import types

import perfbench_cases as cases  # noqa: F401
import pytest

from perfbench.harness import spec, stats
from perfbench.harness.drive import StepObs
from perfbench.harness.trace import Trace
from perfbench.metrics import counts

YI = cases.config("yi-6b")


def req(due, times, status="ok", output_len=None):
    return types.SimpleNamespace(
        due_s=due, times=list(times), output_len=output_len or max(len(times), 1),
        failed=status != "ok", engine_req=types.SimpleNamespace(status=status))


def view(requests, **kw):
    base = dict(requests=requests, t_open=10.0, t_due0=10.0, t_close=20.0, t_end=20.5,
                energy_j=None, setup_s=3.5, cfg=YI)
    base.update(kw)
    return types.SimpleNamespace(**base)


def read(name, run):
    return spec.reader(name)(run)


def test_percentile_is_nearest_rank():
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile([1.0, math.inf], 95) == math.inf


def ttft(s):
    """A request's TTFT as the reader counts it, "out" if not due in view()'s window."""
    if not 10.0 <= s.due_s < 20.0:
        return "out"
    return s.times[0] - s.due_s if s.times and not s.failed else None


def test_ttft_counts_missing_and_failed_requests():
    # 19 requests due in the window with TTFT 0.1 .. 1.9 s, one never served,
    # one failed, one due before the window (not counted)
    rs = [req(10.0 + i * 0.4, [10.0 + i * 0.4 + 0.1 * (i + 1)]) for i in range(19)]
    rs += [req(19.0, []), req(12.0, [12.5], status="cancelled"), req(9.0, [9.1])]
    r = view(rs)
    # 21 values, nearest rank of 95% is the 20th: missing and failed sort last
    assert read("ttft_p95_ms", r) == pytest.approx(1e3 * (r.t_end - r.t_open))
    # nearest rank of 90% is the 19th: 1.9 s
    assert stats.tail_ms([v for v in map(ttft, rs) if v != "out"], r, 90) == \
        pytest.approx(1900.0)
    r2 = view(rs[:19] + rs[-1:])
    assert read("ttft_p95_ms", r2) == pytest.approx(1900.0)


def test_tpot_over_the_tokens_of_the_window():
    rs = [req(10.0, [10.2, 10.3, 10.5]),            # 0.15 s a token
          req(11.0, [11.1, 11.2]),                  # 0.10
          req(12.0, [12.3]),                        # one token: no gap yet
          req(13.0, [])]                            # missing
    r = view(rs)
    # three values with one missing: the 95th percentile is the missing one
    assert read("tpot_p95_ms", r) == pytest.approx(1e3 * (r.t_end - r.t_open))
    assert read("tpot_p95_ms", view(rs[:3])) == pytest.approx(150.0)


def test_rate_energy_and_setup():
    rs = [req(9.0, [9.5, 10.0, 10.5, 20.4]), req(15.0, [15.1, 20.6])]
    r = view(rs, energy_j=8.0)
    # tokens at 10.0, 10.5, 20.4 and 15.1 fall in [10, 20.5]
    assert read("output_tokens_per_s", r) == pytest.approx(4 / 10.5)
    assert read("energy_j_per_token", r) == pytest.approx(2.0)
    assert read("energy_j_per_token", view(rs)) is None
    assert read("setup_s", r) == 3.5


def test_counts_by_hand():
    # one layer's paged decode over 2 sequences of 15 and 31 cached tokens:
    # 48 keys, 32 heads of 128: 4 * 32 * 128 * 48 FLOPs; K and V of 4 kv heads
    # bf16 for 48 tokens, q and o of 2 rows, 2 lengths and 4 + 8 page ids (block 4)
    f, b = counts.paged_decode_call([15, 31], YI)
    assert YI["head_dim"] == 16 and YI["num_attention_heads"] == 4
    assert f == 4 * 4 * 16 * 48
    assert b == 2 * 2 * 2 * 16 * 48 + 2 * 2 * 4 * 16 * 2 + 4 * (2 + 4 + 8)
    f, b = counts.paged_prefill_call(8, 4, YI)
    assert f == 4 * 4 * 16 * (4 * 8 + 10)
    assert b == 2 * 2 * 2 * 16 * 12 + 2 * 2 * 4 * 16 * 4 + 4 * 2
    assert counts.bound_s(989e12, 0) == 1.0 and counts.bound_s(0, 3.35e12) == 1.0


def test_matmul_params_of_the_configs():
    yi = spec.load_cell("yi-6b.sharegpt").config
    moe = spec.load_cell("qwen2-moe-a2.7b.offline").config
    # all weights but the embedding table and lm_head
    assert counts.matmul_params(yi) == yi["params"] - 2 * 64000 * 4096
    per_layer = 2048 * 3 * 2048 + 2048 * 2048 + 2048 * 60 + 4 * 3 * 2048 * 1408 \
        + 3 * 2048 * 5632
    assert counts.matmul_params(moe) == 24 * per_layer
    step = StepObs(0.0, 1.0, decode_ctx=[10], chunks=[(0, 3)], tokens_out=1)
    want = (2 * counts.matmul_params(yi) * 4 + 2 * 4096 * 64000 * 2
            + 32 * 4 * 32 * 128 * (11 + 6))
    assert counts.step_flops(step, yi) == want


def traced_run(cfg, obs, traced, kernels, launches, window_s=2.0, busy_s=0.5):
    tr = Trace(window_s, busy_s, {k: v[1] for k, v in kernels.items()},
               {k: v[0] for k, v in kernels.items()}, [], [])
    return types.SimpleNamespace(cfg=cfg, obs=obs, traced=traced, trace=tr, launches=launches)


def test_per_layer_readers_on_a_synthetic_trace():
    layers = YI["num_hidden_layers"]
    obs = [StepObs(0.0, 0.1, [5, 6], [], 2), StepObs(0.1, 0.2, [6, 7], [(0, 4)], 3),
           StepObs(1.0, 1.1, [7, 8], [(4, 4)], 3), StepObs(2.0, 2.2, [8], [], 1)]
    kernels = {"void paged_decode_kernel<bf16>": (layers, 1e-3),
               "paged_prefill_mma_kernel": (layers, 5e-4), "gemm": (9, 0.2)}
    r = traced_run(YI, obs, (0.95, 1.15), kernels, {"decode": layers, "prefill": layers})
    # untraced: steps 0, 1 (0.2 s) and 3 (0.2 s)
    assert read("engine.step_ms.lat", r) == pytest.approx(1e3 * 0.4 / 3)
    assert read("sched.decode_batch.tput", r) == pytest.approx(6 / 3)
    assert read("engine.tokens_per_s.tput", r) == pytest.approx(6 / 0.4)
    flops = sum(counts.step_flops(o, YI) for o in (obs[0], obs[1], obs[3]))
    assert read("mfu.lat", r) == pytest.approx(100 * flops / (0.4 * 989e12))
    bound = layers * counts.bound_s(*counts.paged_decode_call([7, 8], YI))
    assert read("paged_decode_roofline.lat", r) == pytest.approx(100 * bound / 1e-3)
    bound = layers * counts.bound_s(*counts.paged_prefill_call(4, 4, YI))
    assert read("paged_prefill_roofline.lat", r) == pytest.approx(100 * bound / 5e-4)
    assert read("device.idle_share.tput", r) == pytest.approx(75.0)


def test_a_kernel_off_the_path_reads_nothing():
    obs = [StepObs(1.0, 1.1, [7], [], 1)]
    r = traced_run(YI, obs, (0.9, 1.2), {"gemm": (3, 0.1)}, {"decode": 0, "prefill": 0})
    assert read("paged_decode_roofline.tput", r) is None
    assert read("paged_prefill_roofline.lat", r) is None
    # launches the trace and the kernel's counter disagree on read nothing
    kernels = {"paged_decode_kernel": (YI["num_hidden_layers"], 1e-3)}
    r = traced_run(YI, obs, (0.9, 1.2), kernels, {"decode": 1, "prefill": 0})
    assert read("paged_decode_roofline.tput", r) is None
    r = traced_run(YI, [], (0.0, 0.0), {}, {}, busy_s=0.0)
    assert read("engine.step_ms.tput", r) is None and read("device.idle_share.tput", r) is None
    assert read("engine.tokens_per_s.tput", r) is None
