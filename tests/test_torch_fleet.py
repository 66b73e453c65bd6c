"""The port's fleet simulator (serving/fleet.py) and its vector core
(serving/vector_core.py), held == to the live reference: `simulate_fleet`
under both routing policies, both batching policies and both simulation
cores, and under a fault trace; `VectorFleetSim` in parity mode (its lanes'
results) and in scale mode (`stats()`); and `HeapDispatcher`'s picks. Each
side builds its inputs from its own package.
"""
import numpy as np
import pytest

from _torch_parity import assert_same
from repro.core import disagg as rdisagg
from repro.distributed import fault as rfault
from repro.serving import fleet as rfleet
from repro.serving import vector_core as rvector
from repro.serving import workload as rwork
from repro_torch.core import disagg
from repro_torch.distributed import fault
from repro_torch.serving import fleet, vector_core, workload

PORT = (disagg, fault, fleet, vector_core, workload)
REF = (rdisagg, rfault, rfleet, rvector, rwork)
COUNTS = {"standalone": 2, "dpd-t4": 1, "spec-llama-1b": 1}


def _fleet_run(mods, policy, batching, core, faults=False):
    dmod, fmod, flmod, _, wmod = mods
    ds = wmod.DATASETS["sharegpt"]
    reqs = wmod.sample_mixture_requests(ds, 3.0, 20.0, seed=5)
    spec = flmod.FleetSpec.of_counts(dmod.standard_catalog(), COUNTS)
    kw = dict(policy=policy, batching=batching, core=core, seed=2)
    if policy == "bucketed":
        buckets = flmod.SizeBuckets.from_dataset(ds)
        n = spec.total_count
        kw.update(buckets=buckets, assignment={
            (i, j): tuple(r for r in range(n) if (r + i + j) % 2)
            for i in range(buckets.shape[0]) for j in range(buckets.shape[1])})
    if faults:
        kw["faults"] = fmod.FaultTrace((
            fmod.FaultEvent(at_s=3.0, kind="kill", replica=1),
            fmod.FaultEvent(at_s=5.0, kind="preempt", replica=2, notice_s=2.0)))
    return flmod.simulate_fleet(spec, reqs, **kw)


@pytest.mark.parametrize("core", ["replica", "vector"])
@pytest.mark.parametrize("batching", ["serialized", "continuous"])
@pytest.mark.parametrize("policy", ["least_loaded", "bucketed"])
def test_simulate_fleet_equals_reference(policy, batching, core):
    got = _fleet_run(PORT, policy, batching, core)
    want = _fleet_run(REF, policy, batching, core)
    assert want.total_tokens > 0
    assert_same(got, want)


@pytest.mark.parametrize("core", ["replica", "vector"])
def test_simulate_fleet_under_faults_equals_reference(core):
    got = _fleet_run(PORT, "least_loaded", "continuous", core, faults=True)
    want = _fleet_run(REF, "least_loaded", "continuous", core, faults=True)
    assert want.merged.status_counts()["killed"] >= 1
    assert_same(got, want)


def _vector(mods, name, rng_mode, n_rep, qps, batching="serialized"):
    dmod, _, _, vmod, wmod = mods
    ds = wmod.DATASETS["sharegpt"]
    cfg = next(c for c in dmod.standard_catalog() if c.name == name)
    reqs = wmod.sample_requests(ds, qps=qps, duration_s=30.0, seed=3,
                                fixed_size=ds.size_at("p50"))
    return vmod.VectorFleetSim(cfg.mode, cfg.target, [reqs[i::n_rep] for i in range(n_rep)],
                               draft_cfg=cfg.draft, seeds=[11 + i for i in range(n_rep)],
                               rng_mode=rng_mode, batching=batching,
                               record_segments=rng_mode == "sequential").drain()


@pytest.mark.parametrize("batching", ["serialized", "continuous"])
@pytest.mark.parametrize("name", ["standalone", "spec-llama-1b", "dpd-t4", "dsd-t4-llama-1b"])
def test_vector_core_parity_mode_equals_reference(name, batching):
    got = _vector(PORT, name, "sequential", 3, 1.5, batching)
    want = _vector(REF, name, "sequential", 3, 1.5, batching)
    assert_same(got.results(), want.results())
    assert_same(got.stats(), want.stats())


@pytest.mark.parametrize("name", ["standalone", "dsd-t4-llama-1b"])
def test_vector_core_scale_mode_stats_equal_reference(name):
    got = _vector(PORT, name, "batched", 40, 60.0)
    want = _vector(REF, name, "batched", 40, 60.0)
    stats = want.stats()
    assert stats["finished"] == stats["n_requests"] > 1000
    assert_same(got.stats(), stats)


def _mixed_stream(wmod, n, seed):
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(0.25))
        reqs.append(wmod.Request(
            i, t, int(rng.integers(64, 1024)), int(rng.integers(16, 256)),
            slo_class=("tight", "standard", "relaxed")[int(rng.integers(3))],
            session_id=int(rng.integers(12)) if rng.random() < 0.3 else None))
    return reqs


def _picks(mods, batching):
    """Every pick of a heap dispatcher over a mixed fleet, with a removal,
    a booting replacement, syncs and restricted candidate pools."""
    dmod, _, flmod, _, wmod = mods
    by_name = {c.name: c for c in dmod.standard_catalog()}
    heap = flmod.HeapDispatcher(batching=batching)
    for rid, name in enumerate(("standalone", "dpd-t4", "spec-llama-1b") * 3):
        heap.add(rid, by_name[name], ready_s=0.0)
    rng = np.random.default_rng(7)
    picks = []
    for i, req in enumerate(_mixed_stream(wmod, 300, 1)):
        pool = (None, tuple(sorted(heap.configs))[::2])[i % 2]
        picks.append(heap.pick(req, pool))
        if i == 100:
            heap.remove(sorted(heap.configs)[0])
        if i == 200:
            heap.add(9, by_name["standalone"], ready_s=req.arrival_s + 30.0)
        if i % 37 == 0:
            heap.sync(sorted(heap.configs)[int(rng.integers(len(heap.configs)))],
                      req.arrival_s + float(rng.random()))
    return picks, heap._busy_class


@pytest.mark.parametrize("batching", ["serialized", "continuous"])
def test_heap_dispatcher_picks_equal_reference(batching):
    got, want = _picks(PORT, batching), _picks(REF, batching)
    assert len(set(want[0])) > 3
    assert_same(got, want)
