"""Mélange-style min-carbon fleet allocator (provisioning-time decisions).

GreenLLM's scheduler answers "which configuration serves this workload";
this module answers the fleet question above it: "how many instances of
each (chip, mode) do we provision, and which request sizes go where".
It follows Mélange's formulation (litone01/melange-release) with carbon as
the objective instead of dollars, and EcoServe-style provisioning-time
accounting: a provisioned instance pays its embodied amortization + idle
power for the whole window whether or not it is busy, so the optimizer is
rewarded for packing load onto few, well-utilized, low-carbon instances.

Inputs mirror Mélange's contract:

  workload_distribution  - 2D matrix over (prompt-bucket, output-bucket),
                           cell = fraction of traffic in that size range
                           (rows prompt, cols output; sums to 1)
  gpu_info               - per instance type: max sustained QPS per bucket
                           under the dataset's TTFT/TPOT SLOs (`tputs`,
                           0 = SLO-infeasible), fixed carbon g/hour when
                           provisioned, dynamic carbon g/request per bucket
  total_request_rate     - overall arrival rate (QPS)

`build_gpu_info` derives `gpu_info` analytically from the same perfmodel
rooflines the cluster simulator charges, so allocations validated here
hold up when replayed through `serving.fleet.simulate_fleet`. The solver
is greedy first-fit-decreasing over load slices plus a close/swap local
search - no external ILP dependency, deterministic for fixed inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.carbon import (
    CHIP_DB,
    DEFAULT_CI,
    J_PER_KWH,
    CarbonTrace,
    resolve_ci,
)
from repro_torch.core.disagg import DisaggConfig
from repro_torch.core.spec_decode import expected_tokens_per_round
from repro_torch.serving.batching import (
    BatchPolicy,
    build_dpd_decode_ledger,
    build_single_pool_scheduler,
    prompt_chunks,
    resolve_batch_policy,
)
from repro_torch.serving.costs import (
    dpd_kv_bytes,
    dsd_link_bytes,
    prefill_charges,
    shared_pricer,
    spec_round_charges,
    spec_round_time,
)
from repro_torch.serving.fleet import FLEET_BATCHING_DEFAULT, SizeBuckets
from repro_torch.serving.perfmodel import decode_cost, max_concurrency
from repro_torch.serving.workload import SLO_CLASSES, Dataset, Request, slo_targets

Matrix = tuple[tuple[float, ...], ...]


# ---------------------------------------------------------------------------
# Workload bucketing
# ---------------------------------------------------------------------------
def bucket_workload(requests: Sequence[Request],
                    buckets: SizeBuckets) -> Matrix:
    """Empirical `workload_distribution`: per-bucket traffic fractions."""
    np_, no = buckets.shape
    counts = [[0] * no for _ in range(np_)]
    for r in requests:
        i, j = buckets.index(r.prompt_len, r.output_len)
        counts[i][j] += 1
    n = max(len(requests), 1)
    return tuple(tuple(c / n for c in row) for row in counts)


# ---------------------------------------------------------------------------
# Per-instance-type profile (the gpu_info entry)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InstanceProfile:
    """One Mélange `gpu_info` row, in carbon units."""

    name: str
    tputs: Matrix                    # max sustained QPS per bucket (0 = infeasible)
    carbon_fixed_g_per_hour: float   # embodied amortization + idle power, provisioned
    carbon_per_request_g: Matrix     # dynamic (busy energy) carbon per request
    # physical chips one instance of this type occupies (dpd/dsd use two);
    # empty = exempt from `allocate(inventory=...)` availability limits
    chips: tuple[str, ...] = ()

    def feasible_anywhere(self) -> bool:
        return any(t > 0 for row in self.tputs for t in row)


def _engine_profile(cfg: DisaggConfig, pl: int, ol: int,
                    ds: Dataset, utilization: float):
    """(qps_max, energy_per_request_j, busy_s_per_request_by_chip) of one
    instance on fixed-size load, or (0, inf, {}) when the bucket cannot
    meet the dataset's SLOs.

    Mirrors the simulator's serialized engine: prefills preempt decode, so
    a request's service demand is its prefill time plus its share of the
    decode rounds; `utilization` head-room absorbs Poisson queueing (tail
    TTFT under bursts - do not run interactive engines near 1.0).

    Energy is evaluated at the *operating* batch, not the largest
    SLO-feasible batch: a Little's-law fixed point of `active sequences =
    arrival rate x decode residence` at the utilization target. At low
    target rates engines run small batches where weight reads do not
    amortize - exactly the regime where GreenLLM's old-chip speculative
    modes save energy - and allocating off max-batch numbers would hide
    that."""
    mode = cfg.mode
    new_chip = CHIP_DB[mode.new_chip]
    old_chip = CHIP_DB[mode.old_chip] if mode.old_chip else None
    ctx = pl + ol
    decode_chip = old_chip if mode.kind == "dpd" else new_chip
    cap = min(mode.max_batch, max_concurrency(cfg.target, decode_chip, ctx))
    if mode.kind == "spec":
        cap = min(cap, max_concurrency(cfg.draft, new_chip, ctx))
    if cap < 1:
        return 0.0, math.inf, {}

    # prefill admission: the shared cost schedule (serving/costs.py), so
    # allocator throughputs price exactly what the simulator/engine charge
    sched = prefill_charges(mode.kind, cfg.target, cfg.draft,
                            new_chip, old_chip, pl)
    ttft = sched.duration_s
    pre_energy = sum(c.energy_j for _, c, _ in sched.charges)
    pre_busy: dict[str, float] = {}
    for chip_name, c, _ in sched.charges:
        pre_busy[chip_name] = pre_busy.get(chip_name, 0.0) + c.time_s
    if ttft > ds.ttft_slo_s:
        return 0.0, math.inf, {}

    def round_cost(b: int):
        """(round s, tokens/req/round, round J, busy s by chip) at batch b."""
        if mode.kind in ("standalone", "dpd"):
            c = decode_cost(cfg.target, decode_chip, b, ctx)
            return c.time_s, 1.0, c.energy_j, {decode_chip.name: c.time_s}
        k = mode.spec_k
        draft_chip, c_d, c_t = spec_round_charges(
            mode.kind, cfg.target, cfg.draft, new_chip, old_chip, b, ctx, k)
        busy = {draft_chip.name: c_d.time_s}
        busy[new_chip.name] = busy.get(new_chip.name, 0.0) + c_t.time_s
        if mode.kind == "spec":
            t_round = spec_round_time(mode.kind, c_d, c_t,
                                      mode.interconnect, 0, 0)
        else:
            ids_b, probs_b = dsd_link_bytes(cfg.draft, b, k)
            t_round = spec_round_time(mode.kind, c_d, c_t, mode.interconnect,
                                      ids_b, probs_b,
                                      overlap=mode.overlap_comm)
        return t_round, expected_tokens_per_round(mode.acceptance, k), \
            c_d.energy_j + c_t.energy_j, busy

    def feasible_at(b: int) -> bool:
        t_round, e_tok, _, _ = round_cost(b)
        return t_round / e_tok <= ds.tpot_slo_s

    if not feasible_at(1):
        return 0.0, math.inf, {}
    b_slo = max(b for b in sorted({1, 2, 4, 8, 16, 32, cap})
                if b <= cap and feasible_at(b))

    def rounds_per_req_at(b: int) -> float:
        _, e_tok, _, _ = round_cost(b)
        return max(ol - 1, 0) / e_tok

    def lambda_max_at(b: int) -> float:
        """Arrival rate a continuous-batching engine sustains at batch b:
        Little's law with the prefill time share carved out -
        b = lam * rounds * t_round / (1 - lam * p)  =>
        lam = b / (rounds * t_round + b * p)."""
        t_round, _, _, _ = round_cost(b)
        denom = rounds_per_req_at(b) * t_round + b * ttft
        if mode.kind == "dpd":
            # pools run concurrently; the binding resource is the slowest
            # of prefill pool, decode pool, and the KV link
            kv_bytes = dpd_kv_bytes(cfg.target, pl)
            return min(1.0 / max(ttft, 1e-12),
                       b / max(rounds_per_req_at(b) * t_round, 1e-12),
                       1.0 / max(mode.interconnect.transfer_time(kv_bytes), 1e-12))
        return b / max(denom, 1e-12)

    qps = utilization * lambda_max_at(b_slo)

    # operating batch at that rate: b = qps * rounds * t_round(b) / (1 - qps*p)
    b_op = b_slo
    phi = min(qps * ttft, 0.9) if mode.kind != "dpd" else 0.0
    for _ in range(8):
        t_round, _, _, _ = round_cost(b_op)
        b_next = min(max(int(round(
            qps * rounds_per_req_at(b_op) * t_round / (1.0 - phi))), 1), b_slo)
        if b_next == b_op:
            break
        b_op = b_next

    t_round, e_tok, en_round, busy_round = round_cost(b_op)
    rounds_per_req = max(ol - 1, 0) / e_tok
    energy = pre_energy + rounds_per_req * en_round / b_op
    busy = dict(pre_busy)
    for chip_name, t in busy_round.items():
        busy[chip_name] = busy.get(chip_name, 0.0) + rounds_per_req * t / b_op
    return qps, energy, busy


def _hs_stats(hs) -> tuple[float, dict[str, float]]:
    """(total energy J, busy seconds by chip) of one `HybridSchedule`."""
    en = sum(c.energy_j for _, c, _ in hs.charges)
    busy: dict[str, float] = {}
    for name, c, _ in hs.charges:
        busy[name] = busy.get(name, 0.0) + c.time_s
    return en, busy


def _engine_profile_continuous(cfg: DisaggConfig, pl: int, ol: int,
                               ds: Dataset, utilization: float,
                               policy: BatchPolicy):
    """`_engine_profile` for the iteration-level continuous executor.

    Mirrors what `ReplicaSim(batching="continuous")` actually serves:
    admission is block-granular (the SAME ledger sizing the executors
    build via batching.py), prefill is chunked and batched - riding
    inside hybrid decode steps for standalone, dedicated budget-bounded
    steps for spec/dsd and the dpd prefill pool - and every step is
    priced through `costs.shared_pricer`'s keyed memo (the entries the
    executors populate). The serialized profile's
    `b * ttft` stop-the-world term disappears from the standalone
    denominator (prefill no longer steals whole iterations), which is
    exactly the capacity the continuous executor recovers; spec/dsd/dpd
    keep the term but amortize it over the prompts one prefill step
    batches."""
    mode = cfg.mode
    new_chip = CHIP_DB[mode.new_chip]
    old_chip = CHIP_DB[mode.old_chip] if mode.old_chip else None
    ctx = pl + ol
    k = mode.spec_k

    # block-granular admission cap (full-lifetime context per sequence)
    if mode.kind == "dpd":
        num_blocks = build_dpd_decode_ledger(
            policy, cfg.target, old_chip).num_blocks
    else:
        num_blocks = build_single_pool_scheduler(
            policy, mode.kind, mode.max_batch, k, cfg.target, cfg.draft,
            new_chip).ledger.num_blocks
    per_seq = -(-ctx // policy.block_size)
    cap = min(mode.max_batch,
              num_blocks // per_seq if per_seq else mode.max_batch)
    if cap < 1:
        return 0.0, math.inf, {}

    # the SAME memo entries the executors populate: profile grids for a
    # configuration the fleet already simulated are pure cache hits
    if mode.kind == "dpd":
        pricer = shared_pricer("dpd", cfg.target, None, new_chip, old_chip,
                               interconnect=mode.interconnect)
    else:
        pricer = shared_pricer(mode.kind, cfg.target, cfg.draft, new_chip,
                               old_chip, k=k, interconnect=mode.interconnect,
                               overlap=mode.overlap_comm)

    def hs_of(chunk_specs, b):
        return pricer.charges(tuple(chunk_specs), (ctx,) * b)

    chunks = prompt_chunks(pl, policy.chunk_tokens)
    grid = sorted({1, 2, 4, 8, 16, 32, cap})

    if mode.kind == "standalone":
        def round_at(b):
            """Steady-state hybrid step: b decode slots + their prefill
            feed (each resident request contributes pl tokens over its
            ol-1 rounds), clipped to the step token budget."""
            need = b * pl / max(ol - 1, 1)
            avail = max(policy.token_budget - b, 0)
            c_tok = int(round(min(need, avail)))
            specs = ((c_tok, pl // 2),) if c_tok >= 1 else ()
            return hs_of(specs, b)

        def feasible_at(b):
            if round_at(b).duration_s > ds.tpot_slo_s:
                return False
            ttft = sum(hs_of((c,), b).duration_s for c in chunks)
            return ttft <= ds.ttft_slo_s

        if ol <= 1:
            # pure-prefill bucket: budget-bounded chunk steps, amortized
            # over the m prompts one step batches
            m = max(policy.token_budget // max(pl, 1), 1)
            hs = hs_of(((pl, 0),) * m, 0) if m > 1 else None
            steps = [hs] if hs else [hs_of((c,), 0) for c in chunks]
            dur = sum(s.duration_s for s in steps) / m
            if sum(hs_of((c,), 0).duration_s for c in chunks) > ds.ttft_slo_s:
                return 0.0, math.inf, {}
            qps = utilization / max(dur, 1e-12)
            en = sum(_hs_stats(s)[0] for s in steps) / m
            busy: dict[str, float] = {}
            for s in steps:
                for cn, t in _hs_stats(s)[1].items():
                    busy[cn] = busy.get(cn, 0.0) + t / m
            return qps, en, busy
        if not feasible_at(1):
            return 0.0, math.inf, {}
        b_slo = max(b for b in grid if b <= cap and feasible_at(b))

        def lam_max(b):
            t = round_at(b).duration_s
            lam_dec = b / max((ol - 1) * t, 1e-12)
            lam_pre = max(policy.token_budget - b, 0) / max(pl * t, 1e-12)
            return min(lam_dec, lam_pre)

        qps = utilization * lam_max(b_slo)
        b_op = b_slo
        for _ in range(8):
            t = round_at(b_op).duration_s
            b_next = min(max(int(round(qps * (ol - 1) * t)), 1), b_slo)
            if b_next == b_op:
                break
            b_op = b_next
        en_round, busy_round = _hs_stats(round_at(b_op))
        # a request is 1 of b_op residents for ol-1 rounds, and its chunk
        # tokens are 1/b_op of the step's feed - both scale as 1/b_op
        rounds = max(ol - 1, 0)
        energy = rounds * en_round / b_op
        busy = {cn: rounds * t / b_op for cn, t in busy_round.items()}
        return qps, energy, busy

    # spec / dsd / dpd: dedicated budget-bounded prefill steps, amortized
    # over the m whole prompts one step batches (chunked when pl exceeds
    # the budget/chunk size)
    pre_chunk = policy.token_budget if mode.kind == "dpd" \
        else policy.chunk_tokens
    pre_split = prompt_chunks(pl, pre_chunk)
    m = max(policy.token_budget // max(pl, 1), 1)
    pre_steps = [hs_of(((pl, 0),) * m, 0)] if m > 1 \
        else [hs_of((c,), 0) for c in pre_split]
    pre_dur = sum(s.duration_s for s in pre_steps) / m
    pre_en = sum(_hs_stats(s)[0] for s in pre_steps) / m
    pre_busy: dict[str, float] = {}
    for s in pre_steps:
        for cn, t in _hs_stats(s)[1].items():
            pre_busy[cn] = pre_busy.get(cn, 0.0) + t / m
    ttft = sum(hs_of((c,), 0).duration_s for c in pre_split)
    if mode.kind == "dpd":
        ttft += mode.interconnect.transfer_time(dpd_kv_bytes(cfg.target, pl))
    if ttft > ds.ttft_slo_s:
        return 0.0, math.inf, {}

    e_tok = 1.0 if mode.kind == "dpd" \
        else expected_tokens_per_round(mode.acceptance, k)
    rounds_per_req = max(ol - 1, 0) / e_tok

    def feasible_at(b):
        return hs_of((), b).duration_s / e_tok <= ds.tpot_slo_s

    if not feasible_at(1):
        return 0.0, math.inf, {}
    b_slo = max(b for b in grid if b <= cap and feasible_at(b))

    def lam_max(b):
        t_round = hs_of((), b).duration_s
        if mode.kind == "dpd":
            # pools run concurrently; slowest of prefill pool, decode
            # pool, and the KV link binds
            kv_bytes = dpd_kv_bytes(cfg.target, pl)
            return min(1.0 / max(pre_dur, 1e-12),
                       b / max(rounds_per_req * t_round, 1e-12),
                       1.0 / max(mode.interconnect.transfer_time(kv_bytes),
                                 1e-12))
        return b / max(rounds_per_req * t_round + b * pre_dur, 1e-12)

    qps = utilization * lam_max(b_slo)
    b_op = b_slo
    phi = min(qps * pre_dur, 0.9) if mode.kind != "dpd" else 0.0
    for _ in range(8):
        t_round = hs_of((), b_op).duration_s
        b_next = min(max(int(round(
            qps * rounds_per_req * t_round / (1.0 - phi))), 1), b_slo)
        if b_next == b_op:
            break
        b_op = b_next
    en_round, busy_round = _hs_stats(hs_of((), b_op))
    energy = pre_en + rounds_per_req * en_round / b_op
    busy = dict(pre_busy)
    for cn, t in busy_round.items():
        busy[cn] = busy.get(cn, 0.0) + rounds_per_req * t / b_op
    return qps, energy, busy


def provisioned_carbon_g_per_hour(mode_chips: Sequence[str], ci: float,
                                  include_idle: bool = False) -> float:
    """Fixed hourly carbon of one provisioned instance.

    Default (EcoServe-style, matches the paper's Eq. 1 applied to the
    reservation window): chips reserved for this service amortize their
    embodied carbon over the reservation whether busy or not. With
    `include_idle`, reserved chips also draw idle power for the whole
    window - the strict beyond-paper accounting of `fig9 --strict`."""
    total = 0.0
    for name in mode_chips:
        chip = CHIP_DB[name]
        total += chip.embodied_rate_g_per_s() * 3600.0
        if include_idle:
            total += chip.idle_power_w * 3600.0 / J_PER_KWH * ci
    return total


def build_gpu_info(
    catalog: Sequence[DisaggConfig],
    dataset: Dataset,
    buckets: SizeBuckets,
    ci: "float | CarbonTrace" = DEFAULT_CI,
    utilization: Optional[float] = None,
    include_idle: bool = False,
    window_s: float = 3600.0,
    batching: "BatchPolicy | str | None" = None,
    slo_class: Optional[str] = None,
    calibration=None,
) -> dict[str, InstanceProfile]:
    """Profile every catalog config over the bucket grid (Mélange gpu_info).

    `utilization` is the per-instance load target: tputs are scaled so the
    solver leaves head-room for Poisson bursts and tail TTFT, and dynamic
    energy is evaluated at the operating batch that target implies. With a
    `CarbonTrace`, the window-average intensity prices the energy - the
    provisioning decision sees the same grid the fleet will run under.

    `batching` selects which executor the profiles model: the default is
    the fleet's iteration-level continuous policy (the real serving
    frontier - see `_engine_profile_continuous`); pass "serialized" to
    profile the legacy stop-the-world-prefill engines.

    `slo_class` gates per-bucket QPS on THAT latency class's TTFT/TPOT
    targets (workload.SLO_CLASSES scales of the dataset's base targets)
    instead of the dataset's single global pair, and - unless
    `utilization` is passed explicitly - provisions at the CLASS's load
    target (a relaxed class spends its TTFT slack on queueing and runs
    its instances hotter; tight keeps burst headroom). This is the
    per-class carbon headroom the priority scheduler then protects at
    serve time. None keeps the dataset targets and the 0.6 default
    (identical to the pre-class profiles).

    `include_idle` accounting: the fixed term charges idle power for the
    whole reservation window, but the roofline step energies the profiles
    sum ALSO include idle draw during busy seconds (P = idle + span*util).
    To avoid double-charging, each request's dynamic energy is credited
    idle_w x busy_s per chip - the profiles then rank by true
    above-idle (marginal) energy under strict accounting.

    `calibration` (a `perfmodel.Calibration`, artifact path, or True for
    the committed artifact) evaluates every profile under the measured
    roofline constants from `benchmarks/kernel_calibration.py` instead of
    the literature defaults."""
    if utilization is None:
        utilization = SLO_CLASSES[slo_class].utilization \
            if slo_class is not None else 0.6
    if not 0 < utilization <= 1:
        raise ValueError(f"utilization must be in (0, 1]: {utilization}")
    if slo_class is not None:
        ttft, tpot = slo_targets(dataset, slo_class)
        # NOTE: the class scaling is baked into the targets here, so the
        # replaced dataset keeps slo_class="standard" (scale 1.0) - also
        # tagging it with `slo_class` would double-encode the class for
        # any downstream slo_targets/slo_ok consumer
        dataset = dataclasses.replace(dataset, ttft_slo_s=ttft,
                                      tpot_slo_s=tpot)
    policy = resolve_batch_policy(batching, default=FLEET_BATCHING_DEFAULT)
    ci_val = resolve_ci(ci, 0.0, window_s)
    from repro_torch.serving import perfmodel

    ctx = (perfmodel.calibrated(None if calibration is True else calibration)
           if calibration else contextlib.nullcontext())
    out: dict[str, InstanceProfile] = {}
    with ctx:
        for cfg in catalog:
            np_, no = buckets.shape
            tputs, dyn = [], []
            for i in range(np_):
                trow, drow = [], []
                for j in range(no):
                    pl, ol = buckets.rep_size(i, j)
                    if policy.kind == "continuous":
                        qps, energy_j, busy = _engine_profile_continuous(
                            cfg, pl, ol, dataset, utilization, policy)
                    else:
                        qps, energy_j, busy = _engine_profile(
                            cfg, pl, ol, dataset, utilization)
                    if include_idle and not math.isinf(energy_j):
                        # idle power during busy seconds is already charged
                        # by the whole-window fixed term; credit it so the
                        # dynamic term is the marginal (above-idle) energy
                        energy_j -= sum(
                            CHIP_DB[cn].idle_power_w * t
                            for cn, t in busy.items())
                        energy_j = max(energy_j, 0.0)
                    trow.append(qps)
                    drow.append(0.0 if math.isinf(energy_j)
                                else energy_j / J_PER_KWH * ci_val)
                tputs.append(tuple(trow))
                dyn.append(tuple(drow))
            out[cfg.name] = InstanceProfile(
                name=cfg.name,
                tputs=tuple(tputs),
                carbon_fixed_g_per_hour=provisioned_carbon_g_per_hour(
                    cfg.mode.chips(), ci_val, include_idle=include_idle),
                carbon_per_request_g=tuple(dyn),
                chips=tuple(cfg.mode.chips()),
            )
    return out


# ---------------------------------------------------------------------------
# The allocation problem
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Allocation:
    """Solver output: instance counts + size-aware routing fractions."""

    counts: dict[str, int]
    # bucket (i, j) -> {type name: requests/s routed there}
    assignment: dict[tuple[int, int], dict[str, float]]
    carbon_g_per_hour: float
    feasible: bool                  # False => some load had no SLO-feasible type
    utilization: dict[str, float]   # mean busy fraction per provisioned type
    # load (req/s) no provisioned-or-provisionable instance could serve at
    # all - only nonzero when `inventory` limits bind (feasible is False)
    unplaced_rate: float = 0.0
    # one-time boot carbon (g) of instances newly started vs `prev_counts`
    boot_g: float = 0.0
    # which backend produced this allocation: "greedy", "lp", or
    # "lp-fallback-greedy" (lp requested but scipy missing / solve failed)
    solver: str = "greedy"

    def total_instances(self) -> int:
        return sum(self.counts.values())

    def fleet_counts(self) -> dict[str, int]:
        return {k: v for k, v in self.counts.items() if v > 0}

    def raise_if_unserved(self) -> "Allocation":
        """Fail loudly when inventory limits left load with no instance."""
        if self.unplaced_rate > 0:
            raise ValueError(
                f"allocation infeasible: {self.unplaced_rate:.3g} req/s had "
                f"no instance within inventory limits (counts={self.counts})")
        return self


@dataclasses.dataclass
class _Slice:
    bucket: tuple[int, int]
    rate: float


@dataclasses.dataclass
class _Instance:
    type_name: str
    load: float = 0.0               # fraction of capacity consumed (<= 1)
    rates: dict[tuple[int, int], float] = dataclasses.field(default_factory=dict)

    def fits(self, frac: float) -> bool:
        return self.load + frac <= 1.0 + 1e-9

    def add(self, bucket: tuple[int, int], rate: float, frac: float) -> None:
        self.load += frac
        self.rates[bucket] = self.rates.get(bucket, 0.0) + rate


def _capacity_frac(info: InstanceProfile, bucket: tuple[int, int],
                   rate: float) -> float:
    t = info.tputs[bucket[0]][bucket[1]]
    return math.inf if t <= 0 else rate / t


def _dynamic_g_per_hour(info: InstanceProfile, bucket: tuple[int, int],
                        rate: float) -> float:
    return rate * 3600.0 * info.carbon_per_request_g[bucket[0]][bucket[1]]


def _allocate_lp(
    workload_distribution: Matrix,
    total_request_rate: float,
    gpu_info: dict[str, InstanceProfile],
    inventory: Optional[dict[str, int]] = None,
    prev_counts: Optional[dict[str, int]] = None,
    boot_carbon_g: float = 0.0,
    window_s: float = 3600.0,
    time_limit_s: float = 60.0,
) -> Optional[Allocation]:
    """Exact MILP formulation of the allocation problem (scipy `milp`).

    Variables: x_n (integer instance counts per type), r_{n,b} (req/s of
    bucket b routed to type n, only where tput_{n,b} > 0), y_n >= x_n -
    prev_n (booted instances, when boot carbon applies), u_b (unplaced
    slack, big-M penalized so the solver serves everything it can).
    Constraints: per-bucket rate conservation sum_n r_{n,b} + u_b =
    rate_b; per-type capacity sum_b r_{n,b}/tput_{n,b} <= x_n; physical
    chip inventory caps. Objective: fixed + dynamic + amortized boot
    carbon per hour - the same g/hour `allocate` reports, so greedy and
    LP solutions compare directly.

    Returns None when scipy's solver is unavailable or the solve fails /
    times out without an incumbent - the caller falls back to greedy.
    """
    try:
        import numpy as np
        from scipy.optimize import LinearConstraint, milp
        from scipy.optimize import Bounds
    except ImportError:
        return None
    mass = sum(c for row in workload_distribution for c in row)
    if mass <= 0:
        return Allocation({}, {}, 0.0, True, {}, solver="lp")
    names = sorted(gpu_info)
    prev = dict(prev_counts) if prev_counts else {}
    boot_g_per_hour = boot_carbon_g * 3600.0 / window_s

    rates: dict[tuple[int, int], float] = {}
    for i, row in enumerate(workload_distribution):
        for j, frac in enumerate(row):
            if frac > 0:
                rates[(i, j)] = frac / mass * total_request_rate
    bkts = sorted(rates)
    pairs = [(ni, bi) for ni, n in enumerate(names) for bi, b in enumerate(bkts)
             if gpu_info[n].tputs[b[0]][b[1]] > 0]

    N, B, P = len(names), len(bkts), len(pairs)
    use_boot = boot_g_per_hour > 0
    # layout: x (N ints) | r (P) | u (B) | y (N, only with boot carbon)
    nvar = N + P + B + (N if use_boot else 0)
    ix = lambda n: n                      # noqa: E731
    ir = lambda p: N + p                  # noqa: E731
    iu = lambda b: N + P + b              # noqa: E731
    iy = lambda n: N + P + B + n          # noqa: E731

    # big-M on unplaced load: dominate the cost of serving one req/s on
    # the most expensive type by a wide margin
    worst = max((info.carbon_fixed_g_per_hour
                 + 3600.0 * max((g for row in info.carbon_per_request_g
                                 for g in row), default=0.0)
                 for info in gpu_info.values()), default=1.0)
    big_m = 1e4 * (worst + boot_g_per_hour + 1.0)

    c = np.zeros(nvar)
    for ni, n in enumerate(names):
        c[ix(ni)] = gpu_info[n].carbon_fixed_g_per_hour
        if use_boot:
            c[iy(ni)] = boot_g_per_hour
    for p, (ni, bi) in enumerate(pairs):
        b = bkts[bi]
        c[ir(p)] = 3600.0 * gpu_info[names[ni]].carbon_per_request_g[b[0]][b[1]]
    for bi in range(B):
        c[iu(bi)] = big_m

    cons = []
    # rate conservation: sum_n r_{n,b} + u_b = rate_b
    a = np.zeros((B, nvar))
    for p, (ni, bi) in enumerate(pairs):
        a[bi, ir(p)] = 1.0
    for bi in range(B):
        a[bi, iu(bi)] = 1.0
    rhs = np.array([rates[b] for b in bkts])
    cons.append(LinearConstraint(a, rhs, rhs))
    # capacity: sum_b r_{n,b} / tput_{n,b} - x_n <= 0
    a = np.zeros((N, nvar))
    for p, (ni, bi) in enumerate(pairs):
        b = bkts[bi]
        a[ni, ir(p)] = 1.0 / gpu_info[names[ni]].tputs[b[0]][b[1]]
    for ni in range(N):
        a[ni, ix(ni)] = -1.0
    cons.append(LinearConstraint(a, -np.inf, np.zeros(N)))
    # boots: y_n >= x_n - prev_n  <=>  x_n - y_n <= prev_n
    if use_boot:
        a = np.zeros((N, nvar))
        for ni in range(N):
            a[ni, ix(ni)] = 1.0
            a[ni, iy(ni)] = -1.0
        cons.append(LinearConstraint(
            a, -np.inf, np.array([float(prev.get(n, 0)) for n in names])))
    # inventory: per chip, sum_n (chips of n that are c) * x_n <= cap
    if inventory is not None:
        chips = sorted(inventory)
        a = np.zeros((len(chips), nvar))
        for ci, chip in enumerate(chips):
            for ni, n in enumerate(names):
                k = sum(1 for cn in gpu_info[n].chips if cn == chip)
                if k:
                    a[ci, ix(ni)] = float(k)
        cons.append(LinearConstraint(
            a, -np.inf, np.array([float(inventory[ch]) for ch in chips])))

    integrality = np.zeros(nvar)
    integrality[:N] = 1
    try:
        res = milp(c, constraints=cons, integrality=integrality,
                   bounds=Bounds(0, np.inf),
                   options={"time_limit": time_limit_s})
    except Exception:
        return None
    if res.x is None:
        return None

    counts = {names[ni]: int(round(res.x[ix(ni)])) for ni in range(N)
              if int(round(res.x[ix(ni)])) > 0}
    assignment: dict[tuple[int, int], dict[str, float]] = {}
    cap_used: dict[str, float] = {}
    for p, (ni, bi) in enumerate(pairs):
        r = float(res.x[ir(p)])
        if r <= 1e-9:
            continue
        n, b = names[ni], bkts[bi]
        assignment.setdefault(b, {})
        assignment[b][n] = assignment[b].get(n, 0.0) + r
        cap_used[n] = cap_used.get(n, 0.0) + r / gpu_info[n].tputs[b[0]][b[1]]
    unplaced = float(sum(res.x[iu(bi)] for bi in range(B)))
    feasible = unplaced <= 1e-9

    # best-effort dump of residual load, mirroring the greedy fallback:
    # inventory stays hard, SLOs do not
    if not feasible:
        def can_open_lp(n: str) -> bool:
            if inventory is None:
                return True
            used: dict[str, int] = {}
            for m, k in counts.items():
                for cn in gpu_info[m].chips:
                    used[cn] = used.get(cn, 0) + k
            return all(used.get(cn, 0) + sum(1 for c2 in gpu_info[n].chips
                                             if c2 == cn) <= inventory[cn]
                       for cn in gpu_info[n].chips if cn in inventory)

        for bi in range(B):
            r = float(res.x[iu(bi)])
            if r <= 1e-9:
                continue
            openable = [n for n in names if can_open_lp(n)]
            if not openable:
                continue
            fb = max(openable, key=lambda n: max(
                t for row in gpu_info[n].tputs for t in row))
            b = bkts[bi]
            counts[fb] = counts.get(fb, 0) + 1
            assignment.setdefault(b, {})
            assignment[b][fb] = assignment[b].get(fb, 0.0) + r
            unplaced -= r
    unplaced = max(unplaced, 0.0)

    carbon = 0.0
    for n, k in counts.items():
        carbon += k * gpu_info[n].carbon_fixed_g_per_hour
    for b, shares in assignment.items():
        for n, r in shares.items():
            carbon += _dynamic_g_per_hour(gpu_info[n], b, r)
    boot_g = boot_carbon_g * sum(
        max(counts.get(n, 0) - prev.get(n, 0), 0)
        for n in set(counts) | set(prev))
    carbon += boot_g * 3600.0 / window_s
    utilization = {n: cap_used.get(n, 0.0) / counts[n] for n in counts}
    return Allocation(counts, assignment, carbon, feasible, utilization,
                      unplaced_rate=unplaced, boot_g=boot_g, solver="lp")


def allocate(
    workload_distribution: Matrix,
    total_request_rate: float,
    gpu_info: dict[str, InstanceProfile],
    slice_factor: int = 4,
    local_search_rounds: int = 3,
    inventory: Optional[dict[str, int]] = None,
    prev_counts: Optional[dict[str, int]] = None,
    boot_carbon_g: float = 0.0,
    window_s: float = 3600.0,
    solver: str = "greedy",
    lp_time_limit_s: float = 60.0,
) -> Allocation:
    """Choose instance counts + routing minimizing provisioned carbon/hour.

    Greedy first-fit-decreasing over `slice_factor` slices per bucket, then
    a local search that (a) tries to close each instance by repacking its
    load elsewhere and (b) tries to retype each instance. Deterministic:
    ties break on (carbon, name).

    `solver="lp"` solves the same problem as a mixed-integer program
    (scipy `milp`; see `_allocate_lp`) - a global optimum instead of the
    greedy's local one, worth it on 100+-chip inventories where FFD +
    local search leaves instances stranded (docs/scaling.md has the
    when-to-use guidance and measured frontier). Falls back to greedy
    cleanly when scipy's solver is unavailable or fails inside
    `lp_time_limit_s`; `Allocation.solver` records which backend answered.

    `inventory` caps physical chip counts ({"a100": K, "t4": M}, Mélange
    availability constraints): an instance type consumes one of each chip
    in its profile's `chips`; types with empty `chips` are exempt. When
    limits leave load with no instance at all, the result reports it via
    `feasible=False` + `unplaced_rate` (see `raise_if_unserved`).

    `prev_counts`/`boot_carbon_g`/`window_s` add a switching cost for the
    autoscaler's re-solves: every instance beyond the still-running count
    of its type pays a one-time `boot_carbon_g` surcharge, amortized into
    the hourly objective over the `window_s` the allocation will serve -
    so scaling up for a short cheap-grid window must win back its boot
    carbon within that window."""
    if total_request_rate < 0:
        raise ValueError("negative request rate")
    if not gpu_info:
        raise ValueError("gpu_info is empty")
    if inventory is not None and any(v < 0 for v in inventory.values()):
        raise ValueError(f"negative inventory: {inventory}")
    if boot_carbon_g < 0:
        raise ValueError(f"negative boot_carbon_g: {boot_carbon_g}")
    if window_s <= 0:
        raise ValueError(f"window_s must be positive: {window_s}")
    if solver not in ("greedy", "lp"):
        raise ValueError(f"unknown solver: {solver!r} "
                         f"(expected 'greedy' or 'lp')")
    if solver == "lp":
        lp = _allocate_lp(workload_distribution, total_request_rate, gpu_info,
                          inventory=inventory, prev_counts=prev_counts,
                          boot_carbon_g=boot_carbon_g, window_s=window_s,
                          time_limit_s=lp_time_limit_s)
        if lp is not None:
            return lp
        out = allocate(workload_distribution, total_request_rate, gpu_info,
                       slice_factor=slice_factor,
                       local_search_rounds=local_search_rounds,
                       inventory=inventory, prev_counts=prev_counts,
                       boot_carbon_g=boot_carbon_g, window_s=window_s)
        out.solver = "lp-fallback-greedy"
        return out
    prev = dict(prev_counts) if prev_counts else {}
    boot_g_per_hour = boot_carbon_g * 3600.0 / window_s
    unplaced_rate = 0.0
    mass = sum(c for row in workload_distribution for c in row)
    if mass <= 0:
        return Allocation({}, {}, 0.0, True, {})
    names = sorted(gpu_info)

    # --- inventory helpers ----------------------------------------------
    def n_of_type(pool: "list[_Instance]", n: str) -> int:
        return sum(1 for inst in pool if inst.type_name == n)

    def chips_free(pool: "list[_Instance]") -> Optional[dict[str, float]]:
        """Remaining chip budget, or None when unconstrained."""
        if inventory is None:
            return None
        free = {c: float(k) for c, k in inventory.items()}
        for inst in pool:
            for c in gpu_info[inst.type_name].chips:
                if c in free:
                    free[c] -= 1
        return free

    def can_open(n: str, pool: "list[_Instance]",
                 freeing: "Optional[_Instance]" = None) -> bool:
        """Could one more instance of type `n` start (optionally retyping
        `freeing`, whose chips return to the pool first)?"""
        free = chips_free(pool)
        if free is None:
            return True
        if freeing is not None:
            for c in gpu_info[freeing.type_name].chips:
                if c in free:
                    free[c] += 1
        need: dict[str, int] = {}
        for c in gpu_info[n].chips:
            need[c] = need.get(c, 0) + 1
        return all(free.get(c, math.inf) >= k for c, k in need.items())

    def boot_surcharge(pool: "list[_Instance]", n: str) -> float:
        """Amortized boot carbon if opening one more `n` exceeds the
        still-running count (prev_counts) of that type."""
        if not boot_g_per_hour:
            return 0.0
        return boot_g_per_hour if n_of_type(pool, n) >= prev.get(n, 0) else 0.0

    # --- slices, hardest (fewest feasible types, biggest) first ----------
    slices: list[_Slice] = []
    for i, row in enumerate(workload_distribution):
        for j, frac in enumerate(row):
            rate = frac / mass * total_request_rate
            if rate <= 0:
                continue
            per = rate / slice_factor
            slices.extend(_Slice((i, j), per) for _ in range(slice_factor))
    feasible = True

    def n_feasible(s: _Slice) -> int:
        return sum(gpu_info[n].tputs[s.bucket[0]][s.bucket[1]] > 0 for n in names)

    slices.sort(key=lambda s: (n_feasible(s),
                               -max(_capacity_frac(gpu_info[n], s.bucket, s.rate)
                                    if n_feasible(s) else 0.0
                                    for n in names
                                    if gpu_info[n].tputs[s.bucket[0]][s.bucket[1]] > 0)
                               if n_feasible(s) else 0.0,
                               s.bucket))

    instances: list[_Instance] = []

    def spread(bucket: tuple[int, int], rate: float,
               pool: "list[_Instance]") -> float:
        """Absorb up to `rate` of `bucket` into `pool`'s spare capacity
        (in iteration order); returns the unabsorbed remainder."""
        remaining = rate
        for inst in pool:
            frac_unit = _capacity_frac(gpu_info[inst.type_name], bucket, 1.0)
            if math.isinf(frac_unit):
                continue
            take = min(remaining, max((1.0 - inst.load) / frac_unit, 0.0))
            if take > 1e-12:
                inst.add(bucket, take, take * frac_unit)
                remaining -= take
            if remaining <= 1e-12:
                break
        return remaining

    def place(s: _Slice, pool: list[_Instance]) -> bool:
        """Best-fit into an open instance; open the cheapest new one else."""
        best_open = None
        for inst in pool:
            frac = _capacity_frac(gpu_info[inst.type_name], s.bucket, s.rate)
            if math.isinf(frac) or not inst.fits(frac):
                continue
            # best fit: leave the least slack (packs tightest)
            key = (-(inst.load + frac), inst.type_name)
            if best_open is None or key < best_open[0]:
                best_open = (key, inst, frac)
        if best_open is not None:
            _, inst, frac = best_open
            inst.add(s.bucket, s.rate, frac)
            return True
        candidates = []
        for n in names:
            frac = _capacity_frac(gpu_info[n], s.bucket, s.rate)
            if math.isinf(frac) or frac > 1.0 + 1e-9:
                continue
            if not can_open(n, pool):
                continue
            # amortize the new instance's fixed cost over the capacity this
            # slice consumes - assumes later slices fill the rest, which the
            # close/retype local search corrects when they do not; a boot
            # surcharge (amortized the same way) biases re-solves toward
            # instances that are already running
            cost = (frac * (gpu_info[n].carbon_fixed_g_per_hour
                            + boot_surcharge(pool, n))
                    + _dynamic_g_per_hour(gpu_info[n], s.bucket, s.rate))
            candidates.append((cost, n, frac))
        if not candidates:
            return False
        cost, n, frac = min(candidates)
        inst = _Instance(n)
        inst.add(s.bucket, s.rate, frac)
        pool.append(inst)
        return True

    for s in slices:
        if place(s, instances):
            continue
        # the slice fits no single instance whole: split it - first across
        # the spare room of open instances, then onto fresh instances of
        # the cheapest type that can serve the bucket, filled to capacity
        # (inventory allowing) - before giving up on feasibility
        remaining = spread(
            s.bucket, s.rate,
            sorted(instances, key=lambda x: (x.load, x.type_name)))
        while remaining > 1e-12:
            candidates = []
            for n in names:
                frac_unit = _capacity_frac(gpu_info[n], s.bucket, 1.0)
                if math.isinf(frac_unit) or not can_open(n, instances):
                    continue
                # cost of one unit of rate on a fresh, eventually-full
                # instance of this type
                cost = (frac_unit * (gpu_info[n].carbon_fixed_g_per_hour
                                     + boot_surcharge(instances, n))
                        + _dynamic_g_per_hour(gpu_info[n], s.bucket, 1.0))
                candidates.append((cost, n, frac_unit))
            if not candidates:
                break
            _, n, frac_unit = min(candidates)
            take = min(remaining, 1.0 / frac_unit)
            if take <= 1e-12:       # degenerate tput: cannot make progress
                break
            inst = _Instance(n)
            inst.add(s.bucket, take, take * frac_unit)
            instances.append(inst)
            remaining -= take
        if remaining <= 1e-12:
            continue
        feasible = False
        # best-effort: dump the remainder onto the max-throughput type
        # regardless of SLO - but inventory limits stay hard, so fall back
        # to overloading a running instance, and report truly unservable
        # load via unplaced_rate
        openable = [n for n in names if can_open(n, instances)]
        if openable:
            fallback = max(openable, key=lambda n: max(
                t for row in gpu_info[n].tputs for t in row))
            inst = _Instance(fallback)
            frac = _capacity_frac(gpu_info[fallback], s.bucket, remaining)
            inst.add(s.bucket, remaining,
                     min(frac, 1.0) if math.isfinite(frac) else 1.0)
            instances.append(inst)
            continue
        serving = [inst for inst in instances if math.isfinite(
            _capacity_frac(gpu_info[inst.type_name], s.bucket, 1.0))]
        if serving:
            inst = min(serving, key=lambda x: (x.load, x.type_name))
            inst.add(s.bucket, remaining,
                     _capacity_frac(gpu_info[inst.type_name], s.bucket, remaining))
        else:
            unplaced_rate += remaining

    # --- local search ----------------------------------------------------
    def repack(load: dict[tuple[int, int], float],
               pool: list[_Instance]) -> bool:
        """Try to absorb `load` into `pool` (mutates on success)."""
        staged = [(inst, dict(inst.rates), inst.load) for inst in pool]
        for bucket, rate in sorted(load.items(), key=lambda kv: -kv[1]):
            if spread(bucket, rate, pool) > 1e-12:
                for inst, rates, ld in staged:   # roll back
                    inst.rates, inst.load = rates, ld
                return False
        return True

    for _ in range(local_search_rounds):
        improved = False
        # (a) close instances, emptiest first
        for inst in sorted(instances, key=lambda x: x.load):
            others = [x for x in instances if x is not inst]
            if others and repack(inst.rates, others):
                instances = others
                improved = True
        # (b) retype: move an instance's whole load to a cheaper type
        for inst in instances:
            cur = gpu_info[inst.type_name]
            cur_cost = cur.carbon_fixed_g_per_hour + sum(
                _dynamic_g_per_hour(cur, b, r) for b, r in inst.rates.items())
            if boot_g_per_hour and \
                    n_of_type(instances, inst.type_name) > prev.get(inst.type_name, 0):
                cur_cost += boot_g_per_hour   # this instance is itself a boot
            for n in names:
                if n == inst.type_name:
                    continue
                cand = gpu_info[n]
                fracs = [_capacity_frac(cand, b, r) for b, r in inst.rates.items()]
                if any(math.isinf(f) for f in fracs) or sum(fracs) > 1.0 + 1e-9:
                    continue
                if not can_open(n, instances, freeing=inst):
                    continue
                cost = (cand.carbon_fixed_g_per_hour
                        + boot_surcharge(instances, n)
                        + sum(_dynamic_g_per_hour(cand, b, r)
                              for b, r in inst.rates.items()))
                if cost < cur_cost - 1e-9:
                    inst.type_name, inst.load = n, sum(fracs)
                    cur, cur_cost = cand, cost
                    improved = True
        if not improved:
            break

    # --- summarize -------------------------------------------------------
    counts: dict[str, int] = {}
    assignment: dict[tuple[int, int], dict[str, float]] = {}
    load_by_type: dict[str, float] = {}
    carbon = 0.0
    for inst in instances:
        counts[inst.type_name] = counts.get(inst.type_name, 0) + 1
        load_by_type[inst.type_name] = load_by_type.get(inst.type_name, 0.0) + inst.load
        info = gpu_info[inst.type_name]
        carbon += info.carbon_fixed_g_per_hour
        for bucket, rate in inst.rates.items():
            carbon += _dynamic_g_per_hour(info, bucket, rate)
            assignment.setdefault(bucket, {})
            assignment[bucket][inst.type_name] = \
                assignment[bucket].get(inst.type_name, 0.0) + rate
    utilization = {n: load_by_type.get(n, 0.0) / counts[n] for n in counts}
    boot_g = boot_carbon_g * sum(
        max(counts.get(n, 0) - prev.get(n, 0), 0)
        for n in set(counts) | set(prev))
    carbon += boot_g * 3600.0 / window_s
    if unplaced_rate > 0:
        feasible = False
    return Allocation(counts, assignment, carbon, feasible, utilization,
                      unplaced_rate=unplaced_rate, boot_g=boot_g)


def fleet_assignment(alloc: Allocation, fleet_replicas: Sequence[DisaggConfig],
                     ) -> dict[tuple[int, int], tuple[int, ...]]:
    """Translate routing fractions into `route_bucketed` replica pools."""
    by_type: dict[str, list[int]] = {}
    for idx, cfg in enumerate(fleet_replicas):
        by_type.setdefault(cfg.name, []).append(idx)
    out: dict[tuple[int, int], tuple[int, ...]] = {}
    for bucket, shares in alloc.assignment.items():
        pool = [i for n, r in sorted(shares.items()) if r > 0
                for i in by_type.get(n, [])]
        if pool:
            out[bucket] = tuple(pool)
    return out
