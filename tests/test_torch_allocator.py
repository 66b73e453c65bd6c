"""The port's min-carbon fleet allocator (core/allocator.py) and carbon-aware
autoscaler (serving/autoscale.py), held == to the live reference:
`bucket_workload`, `build_gpu_info` under both batching policies, `allocate`
with the greedy solver and with the MILP (which must answer itself, not
through the greedy fallback), with an inventory that binds and with running
instances to keep, `fleet_assignment`, and `simulate_autoscaled` on a short
piecewise stream with one kill and one preemption. Each side builds its
inputs from its own package.
"""
import pytest

from _torch_parity import assert_same
from repro.core import allocator as rallocator
from repro.core import carbon as rcarbon
from repro.core import disagg as rdisagg
from repro.distributed import fault as rfault
from repro.serving import autoscale as rautoscale
from repro.serving import fleet as rfleet
from repro.serving import workload as rwork
from repro_torch.core import allocator, carbon, disagg
from repro_torch.distributed import fault
from repro_torch.serving import autoscale, fleet, workload

PORT = (allocator, carbon, disagg, fault, autoscale, fleet, workload)
REF = (rallocator, rcarbon, rdisagg, rfault, rautoscale, rfleet, rwork)
RATE = 40.0     # req/s: a fleet of several instance types


def _inputs(mods, batching=None):
    amod, cmod, dmod, _, _, flmod, wmod = mods
    ds = wmod.DATASETS["sharegpt"]
    buckets = flmod.SizeBuckets.from_dataset(ds)
    dist = amod.bucket_workload(wmod.sample_mixture_requests(ds, 6.0, 45.0, seed=0), buckets)
    trace = cmod.CarbonTrace.sinusoid(cmod.GRID_CI["ciso"], 200.0, 90.0, horizon_s=3600.0)
    info = amod.build_gpu_info(dmod.standard_catalog(), ds, buckets, ci=trace,
                               batching=batching)
    return dist, info


@pytest.mark.parametrize("batching", [None, "serialized"])
def test_bucket_workload_and_gpu_info_equal_reference(batching):
    got, want = _inputs(PORT, batching), _inputs(REF, batching)
    assert abs(sum(map(sum, want[0])) - 1.0) < 1e-12
    assert_same(got, want)


ALLOCATE_CASES = {
    "plain": dict(),
    "inventory": dict(inventory={"t4": 2, "a100": 3, "v100": 1}),
    "prev-counts": dict(prev_counts={"dpd-t4": 2, "spec-llama-300m": 1}, boot_carbon_g=5.0,
                        window_s=600.0),
}


@pytest.mark.parametrize("solver", ["greedy", "lp"])
@pytest.mark.parametrize("case", sorted(ALLOCATE_CASES))
def test_allocate_equals_reference(case, solver):
    kw = dict(ALLOCATE_CASES[case], solver=solver)
    (dist, info), (rdist, rinfo) = _inputs(PORT), _inputs(REF)
    got = allocator.allocate(dist, RATE, info, **kw)
    want = rallocator.allocate(rdist, RATE, rinfo, **kw)
    assert want.solver == solver          # the MILP answered, not the greedy fallback
    assert_same(got, want)
    cat, rcat = disagg.standard_catalog(), rdisagg.standard_catalog()
    spec = fleet.FleetSpec.of_counts(cat, got.fleet_counts())
    rspec = rfleet.FleetSpec.of_counts(rcat, want.fleet_counts())
    assert_same(allocator.fleet_assignment(got, spec.replicas()),
                rallocator.fleet_assignment(want, rspec.replicas()))


def _autoscaled(mods):
    _, cmod, dmod, fmod, asmod, _, wmod = mods
    ds = wmod.DATASETS["sharegpt"]
    by_name = {c.name: c for c in dmod.standard_catalog()}
    reqs = wmod.sample_piecewise_requests(ds, [(0.0, 2.0), (40.0, 10.0), (80.0, 2.0)], 120.0,
                                          seed=4)
    trace = cmod.CarbonTrace.step(40.0, 80.0, 420.0, horizon_s=240.0)
    faults = fmod.FaultTrace((fmod.FaultEvent(at_s=30.0, kind="kill", replica=0),
                              fmod.FaultEvent(at_s=70.0, kind="preempt", replica=1,
                                              notice_s=10.0)))
    return asmod.simulate_autoscaled(
        [by_name["standalone"], by_name["dpd-t4"]], ds, reqs, trace,
        asmod.AutoscalePolicy(boot_s=5.0), seed=0, faults=faults)


def test_simulate_autoscaled_with_faults_equals_reference():
    got, want = _autoscaled(PORT), _autoscaled(REF)
    assert want.deaths() >= 1 and want.boots() > 0
    assert_same(got, want)
    assert_same(got.account(carbon.CarbonTrace.step(40.0, 80.0, 420.0, horizon_s=240.0)),
                want.account(rcarbon.CarbonTrace.step(40.0, 80.0, 420.0, horizon_s=240.0)))
