"""SLO-aware scheduler: the paper's component ③ and Algorithm 1 (§4.3).

Two matrices over [configuration, workload] - carbon C and SLO attainment
SLO_att - are completed from partial profiling via collaborative filtering
(ALS low-rank matrix factorization, as in Paragon/Quasar-style resource
management), then for each workload the scheduler picks the minimum-carbon
configuration among those meeting the SLO target, with a priority-driven
fallback when none does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.profiler import ProfileDB


# ---------------------------------------------------------------------------
# Collaborative filtering: masked ALS matrix factorization
# ---------------------------------------------------------------------------
def als_complete(
    m: np.ndarray,
    mask: np.ndarray,
    rank: int = 3,
    iters: int = 60,
    ridge: float = 1e-2,
    seed: int = 0,
) -> np.ndarray:
    """Fill the unobserved entries of `m` (mask=True where observed)."""
    if mask.all():
        return m.copy()
    if not mask.any():
        raise ValueError("collaborative filtering needs at least one observation")
    n, k = m.shape
    rank = max(1, min(rank, min(n, k)))
    rng = np.random.default_rng(seed)
    mean = float(m[mask].mean())
    std = float(m[mask].std()) or 1.0
    z = np.where(mask, (m - mean) / std, 0.0)
    u = rng.normal(scale=0.1, size=(n, rank))
    v = rng.normal(scale=0.1, size=(k, rank))
    eye = ridge * np.eye(rank)
    for _ in range(iters):
        for i in range(n):
            obs = mask[i]
            if obs.any():
                vv = v[obs]
                u[i] = np.linalg.solve(vv.T @ vv + eye, vv.T @ z[i, obs])
        for j in range(k):
            obs = mask[:, j]
            if obs.any():
                uu = u[obs]
                v[j] = np.linalg.solve(uu.T @ uu + eye, uu.T @ z[obs, j])
    filled = (u @ v.T) * std + mean
    return np.where(mask, m, filled)


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScheduleDecision:
    workload: str
    config: str
    expected_carbon_g_per_token: float
    expected_slo_attainment: float
    feasible: bool           # False => fallback path was taken
    replicas: int = 0        # provisioned instances of `config` (fleet path)


def collaborative_filtering(db: ProfileDB, rank: int = 3, seed: int = 0):
    c, s, mask = db.matrices()
    c_full = als_complete(c, mask, rank=rank, seed=seed)
    s_full = np.clip(als_complete(s, mask, rank=rank, seed=seed), 0.0, 1.0)
    return c_full, s_full


def schedule(
    db: ProfileDB,
    slo_target: float = 0.9,
    priority: str = "slo",            # 'slo' | 'default'
    default_config: Optional[str] = None,
    rank: int = 3,
    seed: int = 0,
    allocation=None,                  # core.allocator.Allocation (fleet path)
) -> dict[str, ScheduleDecision]:
    """Algorithm 1: per workload, argmin-carbon among SLO-feasible configs.

    Fleet-aware path: with `allocation` (the Mélange-style allocator's
    output, core/allocator.py), the candidate set narrows to the configs
    the fleet actually provisions (count > 0), so per-workload decisions
    land on instances that exist; decisions carry the provisioned replica
    count. Configs absent from the profile matrices are ignored; if the
    allocation provisions none of the profiled configs, this falls back to
    the unconstrained Algorithm 1 over all configs."""
    c, s = collaborative_filtering(db, rank=rank, seed=seed)
    default_config = default_config or db.configs[0]
    counts = dict(getattr(allocation, "counts", None) or {})
    candidates = [i for i, n in enumerate(db.configs) if counts.get(n, 0) > 0] \
        if counts else list(range(len(db.configs)))
    if not candidates:
        candidates = list(range(len(db.configs)))
    cand = np.asarray(candidates)
    out: dict[str, ScheduleDecision] = {}
    for j, w in enumerate(db.workloads):
        feasible = cand[s[cand, j] >= slo_target]
        if feasible.size:
            i = int(feasible[np.argmin(c[feasible, j])])
            ok = True
        else:                         # FallbackStrategy(priority)
            default_i = db.configs.index(default_config)
            if priority == "slo" or default_i not in candidates:
                # 'default' must still land on a provisioned instance; an
                # unprovisioned default falls through to best-SLO-in-fleet
                i = int(cand[np.argmax(s[cand, j])])
            else:
                i = default_i
            ok = False
        out[w] = ScheduleDecision(w, db.configs[i], float(c[i, j]), float(s[i, j]),
                                  ok, replicas=counts.get(db.configs[i], 0))
    return out
