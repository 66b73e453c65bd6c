"""Fleet allocation walkthrough: from a traffic profile to a provisioned
heterogeneous fleet, validated in simulation.

    PYTHONPATH=src python examples/torch_fleet_allocate.py

Steps (mirroring Mélange's workload_distribution / gpu_info /
total_request_rate contract, with carbon as the objective):

  1. bucket the expected traffic by (prompt, output) size percentiles
  2. profile every (chip, mode) instance type's SLO-feasible throughput
     and energy per bucket from the analytic perfmodel
  3. solve the min-carbon integer allocation
  4. replay the stream through the multi-instance simulator with
     size-bucketed routing and compare against an all-new-chip fleet
  5. hand the allocation to the SLO-aware scheduler (fleet-aware path)
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
from repro_torch.core.carbon import CarbonTrace, GRID_CI
from repro_torch.core.disagg import standard_catalog
from repro_torch.core.profiler import WorkloadPoint, profile
from repro_torch.core.scheduler import schedule
from repro_torch.serving.fleet import FleetSpec, SizeBuckets, simulate_fleet
from repro_torch.serving.workload import DATASETS, sample_mixture_requests

QPS = 12.0
DUR_S = 45.0


def main():
    ds = DATASETS["sharegpt"]
    catalog = standard_catalog()
    by_name = {c.name: c for c in catalog}
    trace = CarbonTrace.sinusoid(GRID_CI["ciso"], 200.0, 90.0, horizon_s=3600.0)

    # 1. workload distribution over size buckets
    reqs = sample_mixture_requests(ds, QPS, DUR_S, seed=0)
    buckets = SizeBuckets.from_dataset(ds)
    dist = bucket_workload(reqs, buckets)
    print(f"workload: {ds.name} @ {QPS:g} QPS, {len(reqs)} requests, "
          f"bucket grid {buckets.shape}")
    for i, row in enumerate(dist):
        print("  " + " ".join(f"{c:5.2f}" for c in row))

    # 2. per-instance-type profiles (Mélange gpu_info, carbon units)
    info = build_gpu_info(catalog, ds, buckets, ci=trace)
    print("\ninstance types (p50 bucket): tput req/s | dynamic mg/req | fixed g/h")
    for name, p in sorted(info.items()):
        print(f"  {name:22s} {p.tputs[1][1]:6.2f} | "
              f"{p.carbon_per_request_g[1][1] * 1e3:7.3f} | "
              f"{p.carbon_fixed_g_per_hour:6.3f}")

    # 3. min-carbon allocation, vs the all-new-chip restriction
    mixed = allocate(dist, QPS, info)
    all_new = allocate(dist, QPS, {k: v for k, v in info.items()
                                   if not by_name[k].mode.old_chip})
    print(f"\nallocator (mixed):   {mixed.counts}  "
          f"-> {mixed.carbon_g_per_hour:.1f} gCO2/h")
    print(f"allocator (all-new): {all_new.counts}  "
          f"-> {all_new.carbon_g_per_hour:.1f} gCO2/h")

    # 4. validate both fleets in the event-driven simulator
    print("\nsimulated over the diurnal CISO trace:")
    for tag, alloc in (("mixed", mixed), ("all-new", all_new)):
        fleet = FleetSpec.of_counts(catalog, alloc.fleet_counts())
        fr = simulate_fleet(fleet, reqs, policy="bucketed", buckets=buckets,
                            assignment=fleet_assignment(alloc, fleet.replicas()))
        g = fr.account(trace)
        print(f"  {tag:8s} {fleet.describe():42s} "
              f"slo={fr.slo_attainment(ds):.3f} total={g.total_g:.2f} g "
              f"(op {g.operational_g:.2f} + emb {g.embodied_g:.3f})")

    # 5. the SLO-aware scheduler consumes the allocation: per-workload
    # decisions now land on configs the fleet actually provisions
    points = [WorkloadPoint(ds.name, p, q) for p in ("p25", "p50", "p75")
              for q in (1.0, 2.0)]
    db = profile(catalog, points, duration_s=20.0)
    for w, dec in schedule(db, allocation=mixed).items():
        print(f"  schedule[{w}] -> {dec.config} "
              f"(x{dec.replicas} provisioned, feasible={dec.feasible})")


if __name__ == "__main__":
    main()
