"""Model families and engine kinds as files only.

A family is a module perfbench/families/<family>.py, found by the
configuration file's `family` key: the weights it makes and the reference
logits it gives are held bit for bit to digests recorded from the harness
before the families were modules of their own (golden_families.json); a
copy of a family under a new name is found and served with no other edit;
a family with no module fails when its cell is loaded. An engine kind is a
key of the cell's workload file: a reduced dpd cell with an old card runs
correct through `run_cell` on an engine of that kind."""
import hashlib
import json
import pathlib
import shutil
import types

import numpy as np
import perfbench_cases as cases
import pytest
import torch

from perfbench.harness import check, drive, spec

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden_families.json").read_text())
SEED = 2 ** 31 + 77
# (prompt tokens, output tokens, step of the first token) of the served
# requests the reference reads; JUDGED are the ones it is asked about
REQUESTS = ((9, 4, 1), (14, 6, 1), (5, 3, 2), (21, 5, 3))
JUDGED = (0, 1, 3)
RUN_SEED = 2 ** 31 + 211


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
                          ).hexdigest()


def served_set(vocab: int) -> list:
    """Served requests on consecutive decode steps (a schedule the moe
    family's dispatch groups can be rebuilt from)."""
    rng = np.random.default_rng(11)
    out = []
    for i, (p, o, st) in enumerate(REQUESTS):
        prompt = rng.integers(0, vocab, p).astype(np.int32)
        toks = [int(t) for t in rng.integers(0, vocab, o)]
        req = types.SimpleNamespace(out_tokens=toks, req_id=i, status="ok")
        out.append(drive.Served(i, 0.1 * i, prompt, o, req,
                                times=[1.0 + 0.01 * (st + j) for j in range(o)],
                                steps=list(range(st, st + o))))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-moe-a2.7b"])
def test_families_reproduce_the_recorded_weights_and_logits(arch, dtype):
    cfg = cases.config(arch)
    cfg["torch_dtype"] = dtype
    fam = spec.family(cfg["family"])
    want = GOLDEN[f"{arch}/{dtype}"]
    w = fam.make_weights(cfg, SEED, "cpu")
    assert list(w) == list(want["weights"])
    assert {k: digest(v) for k, v in w.items()} == want["weights"]
    served = served_set(cfg["vocab_size"])
    judged = [served[i] for i in JUDGED]
    for quant in (None, "fp8"):
        got = fam.reference_logits(w, cfg, served, judged, quant=quant)
        assert [digest(x) for x in got] == want[f"logits_{quant or 'fp32'}"], quant


def bench_dir_with(tmp_path, family: str, cfg: dict, params: dict):
    """A copy of perfbench/ holding one more cell of `cfg` (its family
    `family`), its mix and workload file, and a BENCHMARK.json naming it."""
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(spec.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(dict(cfg, family=family)))
    (bench_dir / "traffic" / "tiny.json").write_text(json.dumps(cases.MIX))
    (bench_dir / "workloads" / "tiny.tiny.json").write_text(
        json.dumps(dict(params, config="tiny", traffic="tiny")))
    bench = json.loads(spec.BENCHMARK.read_text())
    bench["workloads"].append({"name": "tiny.tiny", "config": "tiny", "traffic": "tiny",
                               "chips": 1, "why": "a reduced cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path / "BENCHMARK.json", bench_dir


def test_a_family_added_as_a_file_is_found_and_served(tmp_path, monkeypatch):
    """A copy of the dense family under a new name, in a bench directory
    of its own: load_cell finds it by the configuration's `family` and
    run.serve makes its weights and serves with it, correct."""
    cases.fake_clock(monkeypatch)
    base = cases.cell("yi-6b", max_batch=6)
    bench, bench_dir = bench_dir_with(tmp_path, "plain", base.config, base.params)
    shutil.copy(bench_dir / "families" / "dense.py", bench_dir / "families" / "plain.py")
    cell = spec.load_cell("tiny.tiny", bench, bench_dir)
    assert pathlib.Path(cell.family.__file__) == bench_dir / "families" / "plain.py"
    view, w, served = cases.run_module().serve(cell, RUN_SEED, 1.0, False, device="cpu")
    done = [s for s in served if s.finished]
    assert len(done) >= 4
    r = check.judge(cell.family, w, cell.config, served, done)
    assert r["max_gap"] == 0.0 and r["tokens"] >= 20


def test_a_family_without_a_module_fails_at_load(tmp_path):
    base = cases.cell("yi-6b")
    bench, bench_dir = bench_dir_with(tmp_path, "nosuch", base.config, base.params)
    with pytest.raises(FileNotFoundError, match=r"families/nosuch\.py"):
        spec.load_cell("tiny.tiny", bench, bench_dir)
    with pytest.raises(FileNotFoundError, match=r"families/_decoder\.py"):
        spec.family("_decoder")


def test_a_dpd_cell_with_an_old_card_runs_correct(monkeypatch):
    """The cell's file asks for a dpd engine with a t4 as the old card:
    run_cell builds that engine and what it serves is correct."""
    run = cases.run_module()
    cases.in_test_process(monkeypatch, run)
    built = []
    real = drive.build_engine

    def spy(*a, **k):
        built.append(real(*a, **k))
        return built[-1]
    monkeypatch.setattr(drive, "build_engine", spy)
    cell = cases.cell("yi-6b", max_batch=8, kind="dpd", old_chip="t4")
    out = run.run_cell(cell, RUN_SEED, 1.2, False, device="cpu")
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 10
    assert out["checks"]["judged_tokens"]["value"] >= 10
    (eng,) = built
    assert eng.kind == "dpd" and eng.old_chip is not None and eng.old_chip.name == "t4"
    assert eng.max_batch == 8


def test_an_engine_without_old_chip_has_none(monkeypatch):
    """Without the key the engine is built as before: no old card."""
    cell = cases.cell("yi-6b", max_batch=4)
    fam = cell.family
    w = fam.make_weights(cell.config, 5, "cpu")
    eng = drive.build_engine(fam.model_config(cell.config), cell.config,
                             fam.program_params(w, cell.config), cell.params, 5, "cpu")
    assert eng.kind == "standalone" and eng.old_chip is None and eng.max_batch == 4
