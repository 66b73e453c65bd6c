"""Carbon accounting for LLM serving (GreenLLM §2.3, Eq. 1-3).

Total carbon of a request = embodied (amortized over hardware lifetime)
+ operational (energy x grid carbon intensity):

    C_req = (t_req / LT) * C_e  +  E_req * CI          (Eq. 3)

The chip database carries both the paper's GPU triple (A100/V100/T4,
Table 1) and the TPU-generation mapping this repo targets (v5e as the
"new" chip, v3/v2 as the "old" chips). All numbers are per-chip and
config-overridable; see DESIGN.md §2 for the adaptation rationale.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Static description of one accelerator generation."""

    name: str
    role: str                 # "new" | "old"
    peak_flops: float         # peak dense FLOP/s at serving dtype (bf16/fp16)
    hbm_bandwidth: float      # bytes/s
    hbm_capacity: float       # bytes
    max_power_w: float        # TDP, watts
    idle_power_w: float       # watts when powered but idle
    embodied_kg: float        # embodied carbon, kgCO2eq per chip
    year: int
    lifetime_years: float = 7.0
    # Interconnect attach rate for disaggregated transfer between pools.
    # Paper: 16 Gbps default GCP network; TPU DCN-class. Per-chip value.
    dcn_gbps: float = 16.0

    @property
    def embodied_g(self) -> float:
        return self.embodied_kg * 1000.0

    def embodied_rate_g_per_s(self, lifetime_years: float | None = None) -> float:
        """gCO2eq per second of amortized embodied carbon (Eq. 1 rate)."""
        lt = (lifetime_years if lifetime_years is not None else self.lifetime_years)
        return self.embodied_g / (lt * SECONDS_PER_YEAR)


# ---------------------------------------------------------------------------
# Chip database.
#
# GPU rows: the paper's Table 1 verbatim (fp16 TFLOPs, GB/s, W, kgCO2).
# NOTE the paper's Table 1 lists V100 FP16 at 28.26 TFLOPs (tensor-core
# FP16 is 112 TFLOPs; the table appears to use non-tensor FP16 FMA rate x2).
# We keep the paper's value for fidelity of the reproduction benchmarks and
# expose overrides for sensitivity studies.
#
# TPU rows: the generation mapping used for the TPU-native system. Embodied
# numbers follow the same ACT-style area+memory magnitudes as the paper's
# GPUs of comparable node/area (see DESIGN.md §2).
# ---------------------------------------------------------------------------
CHIP_DB: Mapping[str, ChipSpec] = {
    # --- paper Table 1 ---
    "a100": ChipSpec("a100", "new", 312e12, 1555e9, 40e9, 400.0, 60.0, 26.34, 2020),
    "v100": ChipSpec("v100", "old", 28.26e12, 900e9, 16e9, 300.0, 40.0, 20.0, 2017),
    "t4": ChipSpec("t4", "old", 65e12, 320e9, 16e9, 70.0, 17.0, 10.3, 2018),
    # --- TPU generation mapping (this repo's target) ---
    "tpu_v5e": ChipSpec("tpu_v5e", "new", 197e12, 819e9, 16e9, 250.0, 55.0, 26.3, 2023),
    "tpu_v3": ChipSpec("tpu_v3", "old", 123e12, 900e9, 32e9, 280.0, 55.0, 20.0, 2018),
    "tpu_v2": ChipSpec("tpu_v2", "old", 46e12, 700e9, 16e9, 200.0, 45.0, 10.3, 2017),
}

# Grid carbon intensities, gCO2eq/kWh (paper §7.5: NCSW/CISO/MISO).
GRID_CI: Mapping[str, float] = {
    "ncsw": 17.0,    # North Central Sweden (low)
    "ciso": 261.0,   # California ISO (medium; paper default)
    "miso": 501.0,   # Midcontinent ISO (high)
}
DEFAULT_CI = GRID_CI["ciso"]

J_PER_KWH = 3.6e6


def operational_carbon_g(energy_j: float, ci_g_per_kwh: float = DEFAULT_CI) -> float:
    """Eq. 2: operational carbon (g) of a request consuming `energy_j` joules."""
    if energy_j < 0:
        raise ValueError(f"negative energy: {energy_j}")
    return energy_j / J_PER_KWH * ci_g_per_kwh


def embodied_carbon_g(
    time_s: float,
    chip: ChipSpec,
    num_chips: int = 1,
    lifetime_years: float | None = None,
) -> float:
    """Eq. 1: embodied carbon (g) amortized over `time_s` of chip occupancy."""
    if time_s < 0:
        raise ValueError(f"negative time: {time_s}")
    return time_s * chip.embodied_rate_g_per_s(lifetime_years) * num_chips


def total_carbon_g(
    time_s: float,
    energy_j: float,
    chip: ChipSpec,
    ci_g_per_kwh: float = DEFAULT_CI,
    num_chips: int = 1,
    lifetime_years: float | None = None,
) -> float:
    """Eq. 3: total = embodied + operational carbon of a request."""
    return embodied_carbon_g(time_s, chip, num_chips, lifetime_years) + operational_carbon_g(
        energy_j, ci_g_per_kwh
    )


@dataclasses.dataclass(frozen=True)
class CarbonBreakdown:
    """Carbon of one execution (request / window), split by source."""

    operational_g: float
    embodied_g: float

    @property
    def total_g(self) -> float:
        return self.operational_g + self.embodied_g

    def __add__(self, other: "CarbonBreakdown") -> "CarbonBreakdown":
        return CarbonBreakdown(
            self.operational_g + other.operational_g,
            self.embodied_g + other.embodied_g,
        )

    def scale(self, k: float) -> "CarbonBreakdown":
        return CarbonBreakdown(self.operational_g * k, self.embodied_g * k)

    @staticmethod
    def zero() -> "CarbonBreakdown":
        return CarbonBreakdown(0.0, 0.0)


def request_carbon(
    busy_time_s: float,
    energy_j: float,
    chip: ChipSpec,
    *,
    ci_g_per_kwh: float = DEFAULT_CI,
    num_chips: int = 1,
    lifetime_years: float | None = None,
) -> CarbonBreakdown:
    """Carbon breakdown for a request occupying `num_chips` of `chip`."""
    return CarbonBreakdown(
        operational_g=operational_carbon_g(energy_j, ci_g_per_kwh),
        embodied_g=embodied_carbon_g(busy_time_s, chip, num_chips, lifetime_years),
    )


def savings_fraction(baseline: CarbonBreakdown, candidate: CarbonBreakdown) -> float:
    """Fractional total-carbon savings of `candidate` vs `baseline` (paper Fig. 9)."""
    if baseline.total_g <= 0:
        return 0.0
    return 1.0 - candidate.total_g / baseline.total_g


# ---------------------------------------------------------------------------
# Time-varying grid carbon intensity.
#
# The paper (§7.5) evaluates at three *static* regional intensities; real
# grids swing by 2-3x over a day (solar duck curve). `CarbonTrace` is a
# piecewise-constant CI signal that `SimResult.account()` integrates the
# simulated energy timeline against, so provisioning decisions (the fleet
# allocator) and sweeps (benchmarks/fleet_sweep.py) can be carbon-aware in
# time, not just in region. A flat trace reproduces scalar-CI accounting
# exactly (tests/test_fleet.py pins this).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CarbonTrace:
    """Piecewise-constant gCO2eq/kWh over time.

    `times_s[i]` is the start of segment i; segment i holds `ci[i]` until
    `times_s[i+1]` (the last value extends to +inf, and `ci[0]` extends
    back to -inf so pre-window energy is still priced). Times must be
    strictly increasing and start at 0.
    """

    times_s: tuple[float, ...]
    ci: tuple[float, ...]

    def __post_init__(self):
        if len(self.times_s) != len(self.ci) or not self.times_s:
            raise ValueError("times_s and ci must be same non-zero length")
        if any(b <= a for a, b in zip(self.times_s, self.times_s[1:])):
            raise ValueError("times_s must be strictly increasing")
        if any(v < 0 for v in self.ci):
            raise ValueError("carbon intensity must be non-negative")

    # ---------------------------------------------------------- constructors
    @staticmethod
    def flat(ci_g_per_kwh: float = DEFAULT_CI) -> "CarbonTrace":
        return CarbonTrace((0.0,), (float(ci_g_per_kwh),))

    @staticmethod
    def step(period_s: float, low: float, high: float,
             start_low: bool = True, horizon_s: float | None = None) -> "CarbonTrace":
        """Square wave alternating `low`/`high` every `period_s` seconds."""
        if period_s <= 0:
            raise ValueError("period_s must be positive")
        horizon = horizon_s if horizon_s is not None else 24 * period_s
        times, vals = [], []
        t, lo = 0.0, start_low
        while t < horizon:
            times.append(t)
            vals.append(low if lo else high)
            t += period_s
            lo = not lo
        return CarbonTrace(tuple(times), tuple(vals))

    @staticmethod
    def sinusoid(mean: float, amplitude: float, period_s: float,
                 steps_per_period: int = 24, horizon_s: float | None = None,
                 phase: float = 0.0) -> "CarbonTrace":
        """Diurnal-style swing, sampled into `steps_per_period` flat steps."""
        import math as _math

        if amplitude > mean:
            raise ValueError("amplitude > mean would give negative CI")
        horizon = horizon_s if horizon_s is not None else period_s
        dt = period_s / steps_per_period
        times, vals = [], []
        t = 0.0
        while t < horizon:
            mid = t + dt / 2
            times.append(t)
            vals.append(mean + amplitude * _math.sin(2 * _math.pi * mid / period_s + phase))
            t += dt
        return CarbonTrace(tuple(times), tuple(vals))

    @staticmethod
    def from_csv(path: str) -> "CarbonTrace":
        """Load `t_seconds,ci_g_per_kwh` rows (header optional, '#' comments).

        Row order does not matter (real exports are often tail-appended or
        region-interleaved): rows are sorted by timestamp, and rows with
        an exactly duplicated timestamp collapse to the LAST occurrence
        (the usual convention for corrected re-publishes of a grid
        boundary). A single-row file is a flat trace."""
        times, vals = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = line.split(",")[:2]
                try:
                    times.append(float(a))
                except ValueError:
                    continue              # header row
                vals.append(float(b))
        by_time = {}                      # last value per timestamp wins
        for t, v in zip(times, vals):
            by_time[t] = v
        if not by_time:
            raise ValueError(f"no data rows in trace CSV: {path}")
        ts = sorted(by_time)
        return CarbonTrace(tuple(ts), tuple(by_time[t] for t in ts))

    def scaled(self, time_scale: float) -> "CarbonTrace":
        """Compress/stretch the time axis by `time_scale` (CI values keep
        their shape): a 24 h daily CSV replayed over a 600 s simulation is
        `trace.scaled(600 / 86400)`."""
        if time_scale <= 0:
            raise ValueError(f"time_scale must be positive: {time_scale}")
        return CarbonTrace(tuple(t * time_scale for t in self.times_s), self.ci)

    # ---------------------------------------------------------- evaluation
    def ci_at(self, t_s: float) -> float:
        import bisect

        i = bisect.bisect_right(self.times_s, t_s) - 1
        return self.ci[max(i, 0)]

    def mean_ci(self, t0_s: float, t1_s: float) -> float:
        """Time-average CI over [t0, t1] (== ci_at(t0) for zero-width)."""
        import bisect

        if t1_s < t0_s:
            raise ValueError(f"inverted interval [{t0_s}, {t1_s}]")
        if t1_s == t0_s:
            return self.ci_at(t0_s)
        # only segments overlapping [t0, t1] contribute; account() calls
        # this once per charged step, so bound the scan to that window
        first = max(bisect.bisect_right(self.times_s, t0_s) - 1, 0)
        last = max(bisect.bisect_right(self.times_s, t1_s) - 1, 0)
        total = 0.0
        for i in range(first, last + 1):
            start = float("-inf") if i == 0 else self.times_s[i]
            end = self.times_s[i + 1] if i + 1 < len(self.times_s) else float("inf")
            lo, hi = max(start, t0_s), min(end, t1_s)
            if hi > lo:
                total += self.ci[i] * (hi - lo)
        return total / (t1_s - t0_s)

    def operational_g(self, energy_j: float, t0_s: float, t1_s: float) -> float:
        """Eq. 2 with time-varying CI: energy spread uniformly over [t0, t1]."""
        return operational_carbon_g(energy_j, self.mean_ci(t0_s, t1_s))


def resolve_ci(ci: "float | CarbonTrace", t0_s: float, t1_s: float) -> float:
    """Scalar CI for energy spent uniformly over [t0, t1]."""
    if isinstance(ci, CarbonTrace):
        return ci.mean_ci(t0_s, t1_s)
    return float(ci)
