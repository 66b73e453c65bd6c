"""What a cell is: its entry in BENCHMARK.json and the data files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by name:

    perfbench/configs/<config>.json     sizes, source, engine knobs, family
    perfbench/families/<family>.py      the program's config, weights and
                                        parameters, and the reference's logits
    perfbench/traffic/<traffic>.json    the mix: sizes, weights, arrivals
    perfbench/workloads/<cell>.json     kind, old_chip, rate, max_batch, lead-in
    perfbench/metrics/<metric>.py       a reader: read(run) -> value or None

so a new cell, configuration, family, mix or metric is new files and new
entries in BENCHMARK.json, never an edit of a file that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def _load(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    moves: str | None       # per-layer metrics only
    workloads: tuple | None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict             # perfbench/configs/<config>.json
    mix: dict                # perfbench/traffic/<traffic>.json
    params: dict             # perfbench/workloads/<cell>.json
    end_to_end: tuple        # Metrics the --trace 0 run reports
    per_layer: tuple         # Metrics the --trace 1 run reports
    family: object           # perfbench/families/<config's family>.py


def _metric(entry: dict) -> Metric:
    return Metric(entry["name"], entry["unit"], entry.get("moves"),
                  tuple(entry["workloads"]) if "workloads" in entry else None)


def cell_metrics(bench: dict, cell: str) -> tuple[tuple, tuple]:
    """(end-to-end, per-layer) metrics that `cell` reports. An end-to-end
    metric without `workloads` is in every cell; a per-layer metric without
    it is in every cell that reports the end-to-end metric it moves."""
    e2e = tuple(m for m in map(_metric, bench["end_to_end"])
                if m.workloads is None or cell in m.workloads)
    names = {m.name for m in e2e}
    layer = tuple(m for m in map(_metric, bench["per_layer"])
                  if (cell in m.workloads if m.workloads is not None else m.moves in names))
    return e2e, layer


def load_cell(name: str, bench_path: pathlib.Path = BENCHMARK,
              bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    bench = _load(bench_path)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {bench_path.name}; "
                       f"known: {sorted(entries)}")
    w = entries[name]
    config = _load(bench_dir / "configs" / f"{w['config']}.json")
    mix = _load(bench_dir / "traffic" / f"{w['traffic']}.json")
    params = _load(bench_dir / "workloads" / f"{name}.json")
    for key, want in (("config", w["config"]), ("traffic", w["traffic"]),
                      ("chips", w["chips"])):
        if params.get(key) != want:
            raise ValueError(f"workloads/{name}.json names {key} {params.get(key)!r}, "
                             f"BENCHMARK.json {want!r}")
    e2e, layer = cell_metrics(bench, name)
    return Cell(name, int(w["chips"]), config, mix, params, e2e, layer,
                family(config["family"], bench_dir))


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The module perfbench/families/<name>.py (see families/__init__.py)."""
    path = bench_dir / "families" / f"{name}.py"
    if name.startswith("_") or not path.is_file():
        raise FileNotFoundError(f"family {name!r} has no module: expected {path}")
    return _module(path, f"perfbench_family_{name}")


def reader(metric: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The `read(run)` function of perfbench/metrics/<metric>.py."""
    return _module(bench_dir / "metrics" / f"{metric}.py", f"perfbench_metric_{metric}").read
