"""Closed-form carbon-efficiency analysis of disaggregation (GreenLLM §5).

Two cases running the same LLM service:

  Case 1 (Standalone):     new chip A only      -> O_A + E_A
  Case 2 (Disaggregation): new chip A + old B   -> O'_A + E'_A + O_B + E_B

Assumptions (paper A.1-A.3): shared grid CI alpha; negligible communication
carbon; the extra time on A in case 2 is small vs B's busy time.

These closed forms are used by tests to cross-check the simulator, and by
`benchmarks/fig14_carbon_intensity.py` / `fig15_lifetime.py` to overlay
theory on measured sweeps.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.carbon import J_PER_KWH


@dataclasses.dataclass(frozen=True)
class CaseInputs:
    """Inputs to the §5 analysis, all per-request (or per fixed work unit)."""

    # Case 1: standalone on new chip A.
    n_a: float       # energy on A, joules
    t_a: float       # busy time on A, seconds
    # Case 2: disaggregated on A (reduced role) + old chip B.
    n_a2: float      # energy on A in case 2, joules
    t_a2: float      # busy time on A in case 2, seconds
    n_b: float       # energy on B, joules
    t_b: float       # busy time on B, seconds
    # Chip embodied totals (gCO2) and lifetimes (seconds).
    emb_a_g: float
    emb_b_g: float
    life_a_s: float
    life_b_s: float


def _op(energy_j: float, alpha_g_per_kwh: float) -> float:
    return energy_j / J_PER_KWH * alpha_g_per_kwh


def _emb(t_s: float, emb_g: float, life_s: float) -> float:
    return t_s / life_s * emb_g


def standalone_carbon_g(c: CaseInputs, alpha: float) -> float:
    return _op(c.n_a, alpha) + _emb(c.t_a, c.emb_a_g, c.life_a_s)


def disaggregated_carbon_g(c: CaseInputs, alpha: float) -> float:
    return (
        _op(c.n_a2 + c.n_b, alpha)
        + _emb(c.t_a2, c.emb_a_g, c.life_a_s)
        + _emb(c.t_b, c.emb_b_g, c.life_b_s)
    )


def carbon_ratio(c: CaseInputs, alpha: float) -> float:
    """Eq. 5 LHS: (disaggregated total) / (standalone total). <1 means savings."""
    return disaggregated_carbon_g(c, alpha) / standalone_carbon_g(c, alpha)


def savings(c: CaseInputs, alpha: float) -> float:
    return 1.0 - carbon_ratio(c, alpha)


def energy_condition_holds(c: CaseInputs) -> bool:
    """Carbon Implication 1 (Eq. 4): disaggregation must consume less energy.

    Necessary condition for carbon savings under A.3 (the embodied-carbon
    delta of adding B is positive): N'_A + N_B < N_A.
    """
    return (c.n_a2 + c.n_b) < c.n_a


def ratio_decomposition(c: CaseInputs, alpha: float) -> tuple[float, float]:
    """Eq. 5 decomposition: ratio = energy_ratio + embodied_residual.

    Returns (energy_ratio, embodied_residual) where
      energy_ratio      = (N'_A + N_B) / N_A
      embodied_residual = (E'_A + E_B - energy_ratio * E_A) / (O_A + E_A)

    Carbon Implication 2: as alpha grows the residual shrinks toward 0, so
    the ratio tends to the energy ratio -> savings increase with alpha iff
    the energy condition (Eq. 4) holds.
    """
    e_a = _emb(c.t_a, c.emb_a_g, c.life_a_s)
    e_a2 = _emb(c.t_a2, c.emb_a_g, c.life_a_s)
    e_b = _emb(c.t_b, c.emb_b_g, c.life_b_s)
    o_a = _op(c.n_a, alpha)
    energy_ratio = (c.n_a2 + c.n_b) / c.n_a
    residual = (e_a2 + e_b - energy_ratio * e_a) / (o_a + e_a)
    return energy_ratio, residual


def lifetime_sensitivity(
    c: CaseInputs, alpha: float, *, new_life_s: float | None = None, old_life_s: float | None = None
) -> float:
    """Eq. 6 driver: carbon ratio with overridden lifetimes.

    Carbon Implication 3: ratio falls (savings rise) as old-chip lifetime
    T_B grows (its amortized embodied rate drops) and as new-chip lifetime
    T_A shrinks (standalone's embodied cost grows).
    """
    c2 = dataclasses.replace(
        c,
        life_a_s=new_life_s if new_life_s is not None else c.life_a_s,
        life_b_s=old_life_s if old_life_s is not None else c.life_b_s,
    )
    return carbon_ratio(c2, alpha)
