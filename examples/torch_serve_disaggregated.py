"""End-to-end driver: serve a small model with batched requests through
GreenLLM's full loop - profile -> collaborative filtering -> SLO-aware
scheduling (Algorithm 1) -> execution - and report carbon/latency.

This is the paper's Figure 5 workflow:
  ① disaggregated system   (cluster simulator over the chip models)
  ② profiler               (sweeps configs x workloads, 70% coverage;
                            the rest is filled by collaborative filtering)
  ③ SLO-aware scheduler    (argmin carbon s.t. SLO attainment >= 90%)

    PYTHONPATH=src python examples/torch_serve_disaggregated.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.disagg import standard_catalog
from repro_torch.core.profiler import WorkloadPoint, profile
from repro_torch.core.scheduler import schedule
from repro_torch.serving.simulator import simulate
from repro_torch.serving.workload import DATASETS, sample_requests


def main():
    catalog = standard_catalog()
    workloads = [WorkloadPoint(ds, "p50", q)
                 for ds in ("sharegpt", "humaneval", "longbench")
                 for q in (0.5, 1.0, 2.0, 4.0)]

    print("profiling (70% coverage; collaborative filtering fills the rest)...")
    db = profile(catalog, workloads, duration_s=60.0, coverage=0.7, seed=1)
    print(f"  profiled {len(db.entries)}/{len(catalog) * len(workloads)} cells\n")

    decisions = schedule(db, slo_target=0.9, priority="slo")

    print(f"{'workload':24s} {'chosen config':20s} {'mg/tok':>8s} {'SLO':>6s} {'ok':>4s}")
    for w, d in decisions.items():
        print(f"{w:24s} {d.config:20s} {d.expected_carbon_g_per_token*1e3:8.4f} "
              f"{d.expected_slo_attainment:6.2f} {str(d.feasible):>4s}")

    # execute one scheduled decision end-to-end and verify the prediction
    w = workloads[1]
    d = decisions[w.key]
    cfg = next(c for c in catalog if c.name == d.config)
    ds = DATASETS[w.dataset]
    reqs = sample_requests(ds, w.qps, 120.0, seed=99, fixed_size=ds.p50)
    res = simulate(cfg.mode, cfg.target, reqs, draft_cfg=cfg.draft, seed=99)
    print(f"\nexecuting {d.config} on {w.key} (fresh seed):")
    print(f"  carbon/token: {res.carbon_per_token()*1e3:.4f} mg "
          f"(scheduler predicted {d.expected_carbon_g_per_token*1e3:.4f})")
    print(f"  SLO attainment: {res.slo_attainment(ds):.2f} "
          f"(predicted {d.expected_slo_attainment:.2f})")
    print(f"  TTFT {res.mean_ttft()*1e3:.1f} ms | TPOT {res.mean_tpot()*1e3:.1f} ms "
          f"(SLOs {ds.ttft_slo_s*1e3:.0f}/{ds.tpot_slo_s*1e3:.0f} ms)")


if __name__ == "__main__":
    main()
