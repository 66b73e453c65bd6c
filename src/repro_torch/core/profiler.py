"""Profiler: the paper's component ② (§4.2).

Sweeps every serving configuration over (application x request size x QPS)
and records latency, energy, and carbon into the two matrices the
SLO-aware scheduler consumes: C (carbon per token) and SLO_att (SLO
attainment), both indexed [configuration, workload].

The measurement backend is the cluster simulator (whose per-iteration
timing model the real-compute engine validates, including measured
speculative-acceptance rates); on real hardware the same `Profiler`
interface is backed by device telemetry (pynvml in the paper).

Entries can be deliberately subsampled (`coverage < 1`) to exercise the
collaborative-filtering completion exactly as the paper describes (Fig. 8:
shaded = profiled, blank = filled by CF).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.carbon import DEFAULT_CI
from repro_torch.core.disagg import DisaggConfig
from repro_torch.serving.simulator import simulate
from repro_torch.serving.workload import DATASETS, Dataset, sample_requests


@dataclasses.dataclass(frozen=True)
class WorkloadPoint:
    """One row of the paper's matrices: an application at a QPS level."""

    dataset: str
    percentile: str          # request-size bucket: p25 | p50 | p75
    qps: float

    @property
    def key(self) -> str:
        return f"{self.dataset}/{self.percentile}@{self.qps:g}"


@dataclasses.dataclass
class ProfileEntry:
    carbon_per_token_g: float
    slo_attainment: float
    mean_ttft_s: float
    mean_tpot_s: float
    energy_j: float
    tokens: int


@dataclasses.dataclass
class ProfileDB:
    configs: list[str]
    workloads: list[str]
    entries: dict[tuple[str, str], ProfileEntry]

    def matrices(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (C, SLO_att, observed-mask), shape [config, workload]."""
        nc, nw = len(self.configs), len(self.workloads)
        c = np.full((nc, nw), np.nan)
        s = np.full((nc, nw), np.nan)
        for (ci, wi), e in self.entries.items():
            i, j = self.configs.index(ci), self.workloads.index(wi)
            c[i, j] = e.carbon_per_token_g
            s[i, j] = e.slo_attainment
        mask = ~np.isnan(c)
        return c, s, mask


def profile(
    catalog: Sequence[DisaggConfig],
    workloads: Sequence[WorkloadPoint],
    duration_s: float = 90.0,
    ci: float = DEFAULT_CI,
    seed: int = 0,
    coverage: float = 1.0,
) -> ProfileDB:
    """Run the sweep. `coverage < 1` leaves a random subset unmeasured."""
    rng = np.random.default_rng(seed)
    entries: dict[tuple[str, str], ProfileEntry] = {}
    for w in workloads:
        ds = DATASETS[w.dataset]
        reqs = sample_requests(ds, w.qps, duration_s, seed=seed,
                               fixed_size=ds.size_at(w.percentile))
        for cfg in catalog:
            if coverage < 1.0 and rng.random() > coverage:
                continue
            res = simulate(cfg.mode, cfg.target, reqs, draft_cfg=cfg.draft, seed=seed)
            entries[(cfg.name, w.key)] = ProfileEntry(
                carbon_per_token_g=res.carbon_per_token(ci),
                slo_attainment=res.slo_attainment(ds),
                mean_ttft_s=res.mean_ttft(),
                mean_tpot_s=res.mean_tpot(),
                energy_j=sum(u.energy_j for u in res.use.values()),
                tokens=res.total_tokens,
            )
    return ProfileDB([c.name for c in catalog], [w.key for w in workloads], entries)
