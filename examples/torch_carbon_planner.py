"""Carbon planner: the §5 closed forms as a what-if tool.

Given a workload's per-request busy/energy profile on the new chip and a
candidate old chip, sweep carbon intensity and lifetimes to map when
disaggregation pays off (Implications 1-3), and cross-check against the
simulator.

    PYTHONPATH=src python examples/torch_carbon_planner.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.core.analysis import CaseInputs, energy_condition_holds, savings
from repro_torch.core.carbon import CHIP_DB, GRID_CI
from repro_torch.core.disagg import standard_catalog
from repro_torch.serving.simulator import ServingMode, simulate
from repro_torch.serving.workload import DATASETS, sample_requests

YEAR = 365.25 * 24 * 3600.0


def main():
    # measure one standalone + one DSD run to extract the §5 case inputs
    ds = DATASETS["sharegpt"]
    reqs = sample_requests(ds, 2.0, 90.0, seed=0, fixed_size=ds.p50)
    t7, d1 = get_config("llama-7b"), get_config("llama-1b")
    base = simulate(ServingMode("standalone", "standalone", "a100"), t7, reqs)
    dsd = simulate(ServingMode("dsd", "dsd", "a100", "t4", acceptance=0.7),
                   t7, reqs, draft_cfg=d1)

    n = max(len(reqs), 1)
    a_b, a_d = base.use["a100"], dsd.use["a100"]
    t4 = dsd.use["t4"]
    case = CaseInputs(
        n_a=a_b.energy_j / n, t_a=a_b.busy_s / n,
        n_a2=a_d.energy_j / n, t_a2=a_d.busy_s / n,
        n_b=t4.energy_j / n, t_b=t4.busy_s / n,
        emb_a_g=CHIP_DB["a100"].embodied_g, emb_b_g=CHIP_DB["t4"].embodied_g,
        life_a_s=7 * YEAR, life_b_s=7 * YEAR)

    print("per-request profile (simulated, ShareGPT P50 @ 2 QPS):")
    print(f"  standalone A100: {case.t_a*1e3:7.1f} ms busy, {case.n_a:7.2f} J")
    print(f"  DSD A100 share:  {case.t_a2*1e3:7.1f} ms busy, {case.n_a2:7.2f} J")
    print(f"  DSD T4 share:    {case.t_b*1e3:7.1f} ms busy, {case.n_b:7.2f} J")
    print(f"  Eq. 4 energy condition holds: {energy_condition_holds(case)}\n")

    print("Implication 2 - savings vs grid carbon intensity:")
    for region, ci in GRID_CI.items():
        sim = 1 - dsd.carbon_per_token(ci) / base.carbon_per_token(ci)
        print(f"  {region:5s} ({ci:5.0f} g/kWh): theory {savings(case, ci)*100:5.1f}% "
              f"| simulator {sim*100:5.1f}%")

    print("\nImplication 3 - lifetime sensitivity (CISO):")
    for old_lt in (5, 7, 10):
        s = savings(CaseInputs(**{**case.__dict__, "life_b_s": old_lt * YEAR}), 261.0)
        print(f"  old T4 lifetime {old_lt:2d}y -> savings {s*100:5.1f}%")
    for new_lt in (2, 4, 7):
        s = savings(CaseInputs(**{**case.__dict__, "life_a_s": new_lt * YEAR}), 261.0)
        print(f"  new A100 lifetime {new_lt:2d}y -> savings {s*100:5.1f}%")


if __name__ == "__main__":
    main()
