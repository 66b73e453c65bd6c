"""A whole run without the card's check: run_cell on the CPU over a reduced
cell, its result line, and `correct` coming out false when the timed path is
broken underneath. Also: run.py refuses to run without a card, and without
the program beside it."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import perfbench_cases as cases
import pytest

from repro_torch.serving import engine as engine_mod
from repro_torch.serving import kv_cache

ROOT = cases.ROOT
SEED = 2 ** 31 + 101
KEYS = ["correct", "attempted", "failed", "metrics", "device", "power_limit_w", "checks"]


@pytest.fixture(scope="module")
def run():
    return cases.run_module()


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(run, trace, monkeypatch):
    cases.in_test_process(monkeypatch, run)
    cell = cases.cell("yi-6b")
    out = run.run_cell(cell, SEED, 1.2, bool(trace), device="cpu")
    assert list(out)[:5] == KEYS[:5] and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 10
    names = {m.name for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(out["metrics"]) <= names
    if trace:
        assert {"engine.step_ms.lat", "mfu.lat"} <= set(out["metrics"])
        assert "breakdown" in out and out["device"]["window_s"] > 0
    else:
        # no energy counter on the CPU: setup_s alone
        assert set(out["metrics"]) == {"setup_s"}
    pool = out["kv_pool"]
    assert 0 < pool["peak_blocks_used"] <= pool["blocks"] == cell.config["engine"]["pool_blocks"]
    json.dumps(out, allow_nan=False)


def test_the_sweep_reads_each_rate_with_the_cells_readers(run, monkeypatch):
    """sweep.rows: one run of the cell a rate over the same weights, its
    tails from the cell's own metric readers; more load, more due."""
    cases.in_test_process(monkeypatch, run)
    monkeypatch.syspath_prepend(str(ROOT / "perfbench"))
    import sweep
    rows = list(sweep.rows(cases.cell("yi-6b"), SEED, 1.0, [10.0, 40.0], device="cpu"))
    assert [r["rate"] for r in rows] == [10.0, 40.0] and rows[0]["due"] < rows[1]["due"]
    for r in rows:
        assert r["output_tokens_per_s"] > 0 and r["ttft_p95_ms"] > 0
        assert 0.0 <= r["attainment"] <= 1.0 and r["waiting_close"] >= 0


def test_a_module_loaded_while_judging_stops_the_result(run, monkeypatch, capsys):
    """The look for jax and the JAX package is made again just before the
    result is printed, after the reference has judged."""
    import torch
    looks = iter([[], ["jax"]])
    monkeypatch.setattr(run, "use_checkout_caches", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"correct": True, "checks": {}}
                        if not next(looks) else None)
    monkeypatch.setattr(run, "forbidden_modules", lambda: next(looks))
    code = run.main(["--workload", "yi-6b.sharegpt", "--seed", "1", "--seconds", "1"])
    assert code == 4 and capsys.readouterr().out == ""


def altered_sample(real):
    """A token changed where it is produced: every decode step's first row."""
    def sample(self, logits):
        tok = real(self, logits)
        if len(tok) > 1:
            tok = tok.copy()
            tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    return sample


def lost_append(real):
    """Every third decode step leaves the cache as it was: its K/V are never
    written."""
    calls = [0]

    def scatter_append(self, seq_ids, k_tok, v_tok, positions):
        calls[0] += 1
        if calls[0] % 3:
            return real(self, seq_ids, k_tok, v_tok, positions)
    return scatter_append


FAULTS = {
    "token_altered": (engine_mod.ServingEngine, "_sample", altered_sample),
    "kv_append_lost": (kv_cache.PagedKVPool, "scatter_append", lost_append),
}


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-moe-a2.7b", "yi-6b.dpd"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(run, monkeypatch, arch, fault):
    """Each fault under each cell's engine kind (yi-6b.dpd: the dpd cell's
    prefill pool, KV handoff and decode pool)."""
    cases.in_test_process(monkeypatch, run)
    owner, name, make = FAULTS[fault]
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    backlog = arch.startswith("qwen")
    dpd = dict(kind="dpd", old_chip="t4") if arch.endswith(".dpd") else {}
    cell = cases.cell(arch.removesuffix(".dpd"), arrivals="backlog" if backlog else "poisson",
                      max_batch=8, **dpd)
    out = run.run_cell(cell, SEED, 1.5, False, device="cpu")
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in out["checks"].items() if k.endswith("_gap"))


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "yi-6b.sharegpt",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert p.returncode == 3 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_without_the_program_beside_it_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and perfbench/ has no
    program to run: the run fails and prints nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['perfbench/tests']; import perfbench_cases as c; "
            "r = c.run_module(); out = r.run_cell(c.cell('yi-6b'), 1, 0.5, False, 'cpu'); "
            "print(out)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=400)
    assert p.returncode != 0 and p.stdout == ""
    assert "repro_torch" in p.stderr


def test_warm_up_covers_every_decode_batch(run):
    """The warm-up's outputs of 2 .. max_batch + 1 tokens take the decode
    batch through every size from max_batch to 1."""
    from perfbench.harness import drive
    cell = cases.cell("yi-6b", max_batch=5)
    cfg, fam = cell.config, cell.family
    w = fam.make_weights(cfg, 3, "cpu")
    eng = drive.build_engine(fam.model_config(cfg), cfg, fam.program_params(w, cfg),
                             cell.params, 3, "cpu")
    sizes = []
    real = engine_mod.ServingEngine._decode_logits

    def spy(self, pool, sids, tokens):
        sizes.append(len(sids))
        return real(self, pool, sids, tokens)

    engine_mod.ServingEngine._decode_logits = spy
    try:
        drive.warm_up(eng, cell.mix, cfg["vocab_size"], 5, np.random.default_rng(0))
    finally:
        engine_mod.ServingEngine._decode_logits = real
    assert set(sizes) == {1, 2, 3, 4, 5} and not eng.active
