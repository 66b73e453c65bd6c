"""The port's planning stack, held == to the live reference: the
disaggregation catalog (core/disagg.py), the §5 closed forms
(core/analysis.py), the profiler at partial coverage (core/profiler.py),
and collaborative filtering with Algorithm 1 (core/scheduler.py). Each side
builds its inputs from its own package; `assert_same` compares them field
by field, with no tolerance.
"""
import dataclasses

import numpy as np
import pytest

from _torch_parity import assert_same
from repro.core import allocator as rallocator
from repro.core import analysis as ranalysis
from repro.core import disagg as rdisagg
from repro.core import profiler as rprofiler
from repro.core import scheduler as rscheduler
from repro_torch.core import allocator, analysis, disagg, profiler, scheduler

# 2 datasets x 2 QPS, 20 s windows: small enough to profile in seconds
POINTS = [("sharegpt", "p50", 1.0), ("sharegpt", "p75", 4.0),
          ("longbench", "p25", 1.0), ("longbench", "p50", 4.0)]
CATALOG_KW = [dict(), dict(target="llama-1b", drafts=("llama-300m",), old_chips=("t4",),
                           spec_k=3, acceptance=0.6)]


@pytest.mark.parametrize("kw", CATALOG_KW, ids=["paper", "small"])
def test_standard_catalog_equals_reference(kw):
    got, want = disagg.standard_catalog(**kw), rdisagg.standard_catalog(**kw)
    assert [c.name for c in got] == [c.name for c in want]
    assert_same(got, want)
    assert disagg.DEFAULT_ACCEPTANCE == rdisagg.DEFAULT_ACCEPTANCE


def _cases(mod, n=64, seed=0):
    """A grid of §5 inputs: energies and times around the paper's scale,
    the old chip's share of the work below and above the break-even."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        n_a, t_a = rng.uniform(50, 500), rng.uniform(0.5, 5.0)
        share = rng.uniform(0.1, 0.9)
        out.append(mod.CaseInputs(
            n_a=n_a, t_a=t_a, n_a2=n_a * (1 - share), t_a2=t_a * (1 - share),
            n_b=n_a * share * rng.uniform(0.5, 1.5), t_b=t_a * share * rng.uniform(1.0, 3.0),
            emb_a_g=rng.uniform(1e4, 3e4), emb_b_g=rng.uniform(5e3, 2e4),
            life_a_s=rng.uniform(3, 6) * 3.15e7, life_b_s=rng.uniform(5, 10) * 3.15e7))
    return out


@pytest.mark.parametrize("alpha", [0.0, 30.0, 261.0, 700.0])
def test_analysis_closed_forms_equal_reference(alpha):
    for got, want in zip(_cases(analysis), _cases(ranalysis)):
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert analysis.energy_condition_holds(got) == ranalysis.energy_condition_holds(want)
        for fn in ("standalone_carbon_g", "disaggregated_carbon_g", "carbon_ratio", "savings",
                   "ratio_decomposition"):
            assert getattr(analysis, fn)(got, alpha) == getattr(ranalysis, fn)(want, alpha), fn
        for lives in (dict(new_life_s=1e8), dict(old_life_s=4e8),
                      dict(new_life_s=2e7, old_life_s=3e8)):
            assert analysis.lifetime_sensitivity(got, alpha, **lives) == \
                ranalysis.lifetime_sensitivity(want, alpha, **lives)


@pytest.fixture(scope="module")
def dbs():
    """(port, reference) ProfileDBs at 70% coverage."""
    out = []
    for dmod, pmod in ((disagg, profiler), (rdisagg, rprofiler)):
        points = [pmod.WorkloadPoint(*p) for p in POINTS]
        out.append(pmod.profile(dmod.standard_catalog(), points, duration_s=20.0,
                                coverage=0.7, seed=3))
    return out


def test_profile_equals_reference(dbs):
    got, want = dbs
    assert 0 < len(want.entries) < len(want.configs) * len(want.workloads)
    assert_same(got, want)
    assert_same(got.matrices(), want.matrices())


@pytest.mark.parametrize("rank,seed", [(3, 0), (2, 5)])
def test_collaborative_filtering_equals_reference(dbs, rank, seed):
    got, want = dbs
    c, s, mask = want.matrices()
    assert_same(scheduler.als_complete(*got.matrices()[::2], rank=rank, seed=seed),
                rscheduler.als_complete(c, mask, rank=rank, seed=seed))
    assert_same(scheduler.collaborative_filtering(got, rank=rank, seed=seed),
                rscheduler.collaborative_filtering(want, rank=rank, seed=seed))


def _allocation(mod, counts):
    return mod.Allocation(counts=counts, assignment={}, carbon_g_per_hour=0.0,
                          feasible=True, utilization={})


# at 0.9 the fleet of standalone and dpd-t4 meets no SLO on longbench p50 @ 4
# QPS, and every other case has a feasible config; at 1.01 every workload
# falls back ("slo": best attainment; "default": the named config, or the
# best attainment where the fleet lacks it)
@pytest.mark.parametrize("slo_target", [0.9, 1.01])
@pytest.mark.parametrize("priority,default", [("slo", None), ("default", "dpd-v100")])
@pytest.mark.parametrize("counts", [None, {"standalone": 2, "dpd-t4": 1, "spec-llama-1b": 0},
                                    {"dsd-v100-llama-300m": 3}],
                         ids=["all", "fleet", "fleet-lacks-default"])
def test_schedule_equals_reference(dbs, slo_target, priority, default, counts):
    got, want = dbs
    kw = dict(slo_target=slo_target, priority=priority, default_config=default)
    g = scheduler.schedule(got, allocation=counts and _allocation(allocator, counts), **kw)
    w = rscheduler.schedule(want, allocation=counts and _allocation(rallocator, counts), **kw)
    assert_same(g, w)
    assert sorted(w) == sorted(want.workloads)
