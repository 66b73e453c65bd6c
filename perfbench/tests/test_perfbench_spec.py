"""BENCHMARK.json and the files it names: every cell resolves its
configuration, mix and metrics by name, a cell added as new files is found
with no edit, and every name, unit and reader keeps to the benchmark's rules."""
import json
import re
import shutil

import perfbench_cases as cases  # noqa: F401  (puts the repo root on sys.path)
import pytest

from perfbench.harness import spec
from repro_torch.core.carbon import CHIP_DB

BENCH = json.loads(spec.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1].startswith("perfbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(kind):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            assert text is None or (1 <= len(text) <= 200 and "\n" not in text)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    # what the cell runs differently from its source is named in `reduced`,
    # each key in the file; no width is ever cut
    assert set(c.config["reduced"]) <= set(c.config)
    assert not [k for k in c.config["reduced"] if k.endswith(("_size", "_dim", "_rank", "_heads"))
                or k in ("num_experts_per_tok", "num_hidden_layers")]
    assert c.params["max_batch"] == 64 and c.params["kind"] in ("standalone", "dpd")
    # dpd hands decode to an older card: the cell's file names it
    assert ("old_chip" in c.params) == (c.params["kind"] == "dpd")
    assert c.params.get("old_chip") in (None, *CHIP_DB)
    assert c.family.__file__.endswith(f"families/{c.config['family']}.py")
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m.name))
    for m in c.per_layer:
        assert m.moves in names


def test_every_metric_has_a_reader_and_every_config_a_cell():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def test_a_cell_added_as_new_files_is_found(tmp_path):
    """A later change adds a configuration, a mix, a cell and a metric as new
    files and entries: the harness finds them with no edit of its code."""
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(spec.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((bench_dir / "configs" / "yi-6b.json").read_text())
    (bench_dir / "configs" / "yi-6b-copy.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "sharegpt.json").read_text())
    (bench_dir / "traffic" / "burst.json").write_text(json.dumps(dict(mix, backlog=7)))
    (bench_dir / "workloads" / "yi-6b-copy.burst.json").write_text(json.dumps(
        {"config": "yi-6b-copy", "traffic": "burst", "kind": "standalone", "chips": 1,
         "rate": 1.0, "max_batch": 8, "checks": {}}))
    (bench_dir / "metrics" / "new_metric.py").write_text("def read(run):\n    return 42.0\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "yi-6b-copy.burst", "config": "yi-6b-copy", "traffic": "burst", "chips": 1,
         "why": "new"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "new_metric", "unit": "%", "better": "higher", "source": "host_clock",
         "layer": "engine", "moves": "setup_s", "workloads": ["yi-6b-copy.burst"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("yi-6b-copy.burst", tmp_path / "BENCHMARK.json", bench_dir)
    assert c.mix["backlog"] == 7 and c.config["arch"] == "yi-6b"
    assert [m.name for m in c.per_layer] == ["new_metric"]
    assert spec.reader("new_metric", bench_dir)(None) == 42.0
    assert {m.name for m in c.end_to_end} == {"energy_j_per_token", "setup_s"}


def test_a_cell_file_must_agree_with_benchmark_json(tmp_path):
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(spec.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    f = bench_dir / "workloads" / "yi-6b.sharegpt.json"
    f.write_text(json.dumps(dict(json.loads(f.read_text()), traffic="offline")))
    with pytest.raises(ValueError, match="traffic"):
        spec.load_cell("yi-6b.sharegpt", spec.BENCHMARK, bench_dir)
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
