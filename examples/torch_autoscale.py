"""Carbon-aware autoscaling walkthrough: ride the grid, breathe with load.

    PYTHONPATH=src python examples/torch_autoscale.py

A diurnal request stream (quiet troughs, busy peaks) is served under a
real CAISO-shaped daily carbon-intensity curve. The controller
(serving/autoscale.py) re-solves the Mélange-style min-carbon allocation
at every grid window boundary:

  - scale-up boots replicas with a boot-time penalty (they reserve - and
    idle - before they serve),
  - scale-down drains replicas (they finish their backlog, then retire),
  - arrivals route online against live replica state,
  - carbon pays for every reserved second: busy energy priced per charged
    segment on the trace, idle/boot power + embodied amortization over
    each replica's reservation span.

Compare against the two fleets an operator could hold statically: sized
for the mean (misses the peak SLO) or sized for the peak (idles through
every trough).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.allocator import (
    allocate,
    bucket_workload,
    build_gpu_info,
    fleet_assignment,
)
from repro_torch.core.carbon import CarbonTrace, resolve_ci
from repro_torch.core.disagg import standard_catalog
from repro_torch.serving.autoscale import AutoscalePolicy, simulate_autoscaled
from repro_torch.serving.fleet import FleetSpec, SizeBuckets, simulate_fleet
from repro_torch.serving.workload import DATASETS, sample_piecewise_requests

DUR_S = 600.0
PEAK_QPS, LOW_QPS = 18.0, 2.0
CSV = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "data",
                   "caiso_daily_ci.csv")


def main():
    ds = DATASETS["sharegpt"]
    catalog = standard_catalog()
    buckets = SizeBuckets.from_dataset(ds)

    # a 24 h CAISO duck curve compressed onto the simulated horizon
    trace = CarbonTrace.from_csv(CSV).scaled(DUR_S / 86400.0)
    profile = [(0.0, LOW_QPS), (DUR_S / 4, PEAK_QPS),
               (DUR_S / 2, LOW_QPS), (3 * DUR_S / 4, PEAK_QPS)]
    reqs = sample_piecewise_requests(ds, profile, DUR_S, seed=1)
    print(f"workload: {ds.name}, {len(reqs)} requests over {DUR_S:g}s, "
          f"load {LOW_QPS:g} <-> {PEAK_QPS:g} QPS; grid "
          f"{min(trace.ci):.0f}-{max(trace.ci):.0f} gCO2/kWh")

    # --- autoscaled ----------------------------------------------------
    res = simulate_autoscaled(
        catalog, ds, reqs, trace,
        AutoscalePolicy(boot_s=15.0, min_window_s=DUR_S / 24), seed=0)
    print("\nwindow log (controller re-solves at grid boundaries):")
    for w in res.windows:
        fleet = " + ".join(f"{k}x {n}" for n, k in sorted(w["counts"].items()))
        marks = "+" * w["boots"] + "-" * w["drains"]
        print(f"  [{w['t0']:5.0f},{w['t1']:5.0f})s ci={w['ci']:5.1f} "
              f"rate={w['rate']:5.1f}/s  {fleet or '(empty)'} {marks}")
    auto_g = res.account(trace, include_idle=True)
    print(f"autoscaled: SLO {res.slo_attainment(ds):.3f}, "
          f"{res.boots()} boots / {res.drains()} drains, peak "
          f"{res.peak_instances()} instances, {auto_g.total_g:.2f} gCO2 "
          f"({auto_g.operational_g:.2f} op + {auto_g.embodied_g:.2f} emb)")

    # --- static baselines ---------------------------------------------
    dist = bucket_workload(reqs, buckets)
    info = build_gpu_info(catalog, ds, buckets,
                          ci=resolve_ci(trace, 0.0, DUR_S), include_idle=True)
    print("\nstatic baselines (one allocation held all day):")
    for tag, rate in (("mean", len(reqs) / DUR_S), ("peak", PEAK_QPS)):
        alloc = allocate(dist, rate, info)
        fleet = FleetSpec.of_counts(catalog, alloc.fleet_counts())
        fr = simulate_fleet(fleet, reqs, policy="bucketed", buckets=buckets,
                            assignment=fleet_assignment(alloc, fleet.replicas()))
        g = fr.account(trace, include_idle=True)
        print(f"  static-{tag}: {fleet.describe()}  SLO "
              f"{fr.slo_attainment(ds):.3f}, {g.total_g:.2f} gCO2")
        if tag == "peak":
            print(f"\nautoscaled vs static-peak: "
                  f"{100 * (1 - auto_g.total_g / g.total_g):.1f}% less carbon "
                  f"at equal-or-better SLO")


if __name__ == "__main__":
    main()
