"""Reduced cells for the CPU tests: the configuration files' structure at
widths a CPU runs in seconds, and a mix of short requests."""
from __future__ import annotations

import copy
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.harness import spec  # noqa: E402

MIX = {"dataset": "tiny", "p25": [5, 3], "p50": [12, 6], "p75": [30, 9],
       "weights": [0.25, 0.5, 0.25], "ttft_limit_s": 0.2, "tpot_limit_s": 0.08,
       "arrivals": "poisson"}
CHECKS = {"failed_requests": 0, "judged_tokens": 10, "max_gap": 1e-3, "mean_gap": 1e-4}


def config(arch: str) -> dict:
    """The configuration file of `arch` cut to a CPU's size (fp32)."""
    cfg = json.loads((spec.BENCH_DIR / "configs" / f"{arch}.json").read_text())
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, head_dim=16,
               vocab_size=97, torch_dtype="float32")
    if cfg["family"] == "moe":
        cfg.update(num_key_value_heads=4, num_experts=6, num_experts_per_tok=2,
                   moe_intermediate_size=24, shared_expert_intermediate_size=48)
    else:
        cfg.update(num_key_value_heads=2, intermediate_size=96)
    cfg["engine"] = dict(cfg["engine"], pool_blocks=256, block_size=4, chunk_tokens=8,
                         token_budget=16)
    return cfg


def cell(arch: str, arrivals: str = "poisson", rate: float = 40.0, max_batch: int = 6,
         lead_s: float = 0.3, dtype: str = "float32", kind: str = "standalone",
         old_chip: str | None = None) -> spec.Cell:
    """A reduced cell of `arch`, reporting the metrics of the full cell of
    its kind and arrivals."""
    mix = dict(copy.deepcopy(MIX), arrivals=arrivals, backlog=24)
    cfg = config(arch)
    cfg["torch_dtype"] = dtype
    params = {"config": arch, "traffic": "tiny", "kind": kind, "chips": 1,
              "rate": rate, "max_batch": max_batch, "lead_s": lead_s,
              "checks": dict(CHECKS)}
    if old_chip is not None:
        params["old_chip"] = old_chip
    bench = json.loads(spec.BENCHMARK.read_text())
    like = ("yi-6b.longbench.dpd" if kind == "dpd" else
            "yi-6b.sharegpt" if arrivals == "poisson" else "qwen2-moe-a2.7b.offline")
    e2e, layer = spec.cell_metrics(bench, like)
    return spec.Cell(f"{arch}.tiny", 1, cfg, mix, params, e2e, layer,
                     spec.family(cfg["family"]))


def run_module():
    """perfbench/run.py as a module (it is a script, not part of the package)."""
    sp = importlib.util.spec_from_file_location("perfbench_run", ROOT / "perfbench" / "run.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


class FakeClock:
    """A host clock that moves TICK seconds each time it is read and jumps
    over sleeps, so a CPU run serves the same requests on any machine."""

    TICK = 0.003

    def __init__(self):
        self.t = 1000.0

    def now(self) -> float:
        self.t += self.TICK
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += max(dt, 0.0)


def fake_clock(monkeypatch) -> FakeClock:
    from perfbench.harness import drive
    clock = FakeClock()
    monkeypatch.setattr(drive, "now", clock.now)
    monkeypatch.setattr(drive, "sleep", clock.sleep)
    return clock


def in_test_process(monkeypatch, run) -> None:
    """A whole run inside a test process: a deterministic clock, and no look
    for jax in sys.modules, which other test files of the same process load
    (the look itself is tested in a process of its own)."""
    fake_clock(monkeypatch)
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])


FAKE_CLOCK_CODE = """
from perfbench.harness import drive
import perfbench_cases as _c
_clock = _c.FakeClock()
drive.now, drive.sleep = _clock.now, _clock.sleep
"""
