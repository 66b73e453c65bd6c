"""The control: the plain reference put in the program's place and computed
in fp8, the precision below the configurations' bf16, has to come out not
correct, and the program's own served tokens correct.

On the card (marker `cuda`) at each cell's own size and load, three seeds,
against the cell's limits. Here on the CPU, at a reduced size in bf16, where
the readings are smaller than at full width: each number the cell compares
reads three times as high or more for the control as for the program."""
import json

import perfbench_cases as cases
import pytest
import torch

from perfbench.harness import check, spec

CELLS = [w["name"] for w in json.loads(spec.BENCHMARK.read_text())["workloads"]]
SEEDS = (2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503)


def limit_checks(cell, r: dict, prefix: str = "") -> bool:
    """Whether readings r (the program's, or prefix "control_") pass the
    cell's gap limits."""
    return all(r[prefix + name] <= lim for name, lim in cell.params["checks"].items()
               if name.endswith("_gap"))


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_where_the_program_passes_reduced(cell_name, monkeypatch):
    cases.fake_clock(monkeypatch)
    full = spec.load_cell(cell_name)
    backlog = full.mix["arrivals"] == "backlog"
    cell = cases.cell(full.config["arch"], arrivals="backlog" if backlog else "poisson",
                      lead_s=0.3, max_batch=8, dtype="bfloat16", kind=full.params["kind"],
                      old_chip=full.params.get("old_chip"))
    cell.params["checks"] = full.params["checks"]
    run = cases.run_module()
    for seed in SEEDS[:2]:
        view, w, served = run.serve(cell, seed, 1.5, False, device="cpu")
        judged = [s for s in served if s.finished]
        r = check.judge(cell.family, w, cell.config, served, judged, control=True)
        assert limit_checks(cell, r), r
        for name in cell.params["checks"]:
            if name.endswith("_gap"):
                assert r["control_" + name] >= 3 * r[name], (name, r)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_at_the_cells_size(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size and load")
    cell = spec.load_cell(cell_name)
    run = cases.run_module()
    for seed in SEEDS:
        view, w, served = run.serve(cell, seed, 30.0, False)
        judged = check.sample([s for s in served if s.times and s.times[-1] >= view.t_open],
                              seed, run.SAMPLE)
        r = check.judge(cell.family, w, cell.config, served, judged, control=True)
        assert limit_checks(cell, r), r
        assert not limit_checks(cell, r, "control_"), r
        del w, served
        torch.cuda.empty_cache()
