"""Carbon-aware autoscaling: re-solve the fleet per grid-intensity window.

GreenLLM's carbon wins depend on grid intensity (§6, Fig. 14), and real
grids swing 2-3x within a day - but a fleet provisioned once (fleet.py +
core/allocator.py) holds its allocation for the whole run, burning
embodied + idle carbon through every clean-grid trough and serving dirty
-grid peaks with whatever mix the average favored. This module is the
EcoServe-style online controller on top of the steppable `ReplicaSim`:

  - arrivals are routed ONLINE by the shared `OnlineDispatcher`
    (fleet.py) against live replica state - no offline pre-partitioning;
  - at every `CarbonTrace` window boundary the Mélange allocator is
    re-solved for the window's grid intensity and arrival rate - the
    clairvoyant oracle rate or a forecast (`rate_estimator=
    "last_window"|"ewma"`) - with per-chip `inventory` limits and a
    switching cost (`boot_carbon_g` amortized over the window) so
    thrashing instances between windows is penalized;
  - scale-up boots new replicas with a boot-time penalty: the instance
    reserves (and idles) from the boundary but serves only `boot_s`
    later (`ReplicaSim(start_s=...)` semantics);
  - scale-down drains surplus replicas: they take no new arrivals,
    finish their backlog, and retire when idle;
  - carbon: each replica's busy energy is priced per charged segment
    against the trace (core/carbon.py segment accounting), and its
    idle/boot power + embodied amortization cover its whole reservation
    span [reserve_start, retired] - so an autoscaled fleet pays for every
    second it held hardware, including boots that never served.

`simulate_autoscaled` is deterministic for fixed inputs, and
benchmarks/autoscale_sweep.py compares it against the best static
allocation on the same stream (the PR's acceptance headline).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.allocator import (
    Allocation,
    InstanceProfile,
    allocate,
    bucket_workload,
    build_gpu_info,
)
from repro_torch.core.carbon import CarbonBreakdown, CarbonTrace, resolve_ci
from repro_torch.core.disagg import DisaggConfig
from repro_torch.serving.batching import BatchPolicy, resolve_batch_policy
from repro_torch.serving.fleet import (
    FLEET_BATCHING_DEFAULT,
    OnlineDispatcher,
    SizeBuckets,
    make_dispatcher,
)
from repro_torch.serving.simulator import ReplicaSim, SimResult
from repro_torch.serving.workload import SLO_CLASSES, Dataset, Request


# ---------------------------------------------------------------------------
# Controller configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Knobs of the window controller."""

    boot_s: float = 30.0            # boot delay before a new replica serves
    # proactive: initiate boots boot_s before the window boundary (the
    # boundary is known from the trace), so capacity is live when the
    # window opens; the reservation - and its idle carbon - still starts
    # at boot initiation. False = reactive: boot at the boundary, serve
    # boot_s into the window. NOTE: a proactive boot can overlap the
    # outgoing fleet's reservations by up to boot_s (the handover
    # transient); `inventory` is enforced against replicas still
    # *draining* at the boundary, not against that transient.
    proactive: bool = True
    # one-time carbon surcharge per boot fed to the allocator's switching
    # term; None = derived from the dirtiest catalog profile's fixed rate
    # over boot_s (a boot wastes at least its own reservation)
    boot_carbon_g: Optional[float] = None
    inventory: Optional[dict[str, int]] = None   # per-chip-type caps
    # per-instance load target (head-room); None = the `slo_class`'s own
    # target when one is set (a relaxed fleet runs hotter), else 0.6
    utilization: Optional[float] = None
    min_window_s: float = 0.0       # merge trace windows shorter than this
    slice_factor: int = 4
    # per-replica scheduler policy (serving/batching.py); None = the fleet
    # default (iteration-level continuous batching)
    batching: "BatchPolicy | str | None" = None
    # EWMA smoothing for rate_estimator="ewma" (weight of the newest
    # observed window rate)
    ewma_alpha: float = 0.5
    # SLO class the window re-solves provision for (None = the dataset's
    # own targets). Provisioning a mixed-class stream at its tightest
    # present class is the conservative single-knob option; the class-
    # split allocation lives in benchmarks/priority_sweep.py
    slo_class: Optional[str] = None
    # drain-aware scale-up: when a window both drains replicas AND boots
    # replacements (a type switch - e.g. a CI swing flips the optimal
    # config), reclaim the backlog the victims have done no work for
    # (ReplicaSim.reclaim_pending) and re-route it onto the new capacity
    # instead of stalling it behind the drain. Gated on same-window boots:
    # on a pure scale-down the victims drain their own backlog in
    # parallel, which both finishes sooner and frees no extra hardware by
    # rerouting. Handed-off requests re-enter at the window boundary
    # (their latency clock restarts there: each replica's arrival stream
    # must stay time-sorted), so the window log's `handoffs` count is the
    # honest record of the displaced queue
    drain_handoff: bool = True
    # extra re-solve boundaries on load change: probe the arrival stream
    # at `load_probe_s` granularity inside each grid window and insert a
    # boundary whenever a probe slice's rate leaves the band
    # (1 +/- threshold) x the rate observed since the last boundary.
    # Causal (a boundary at t uses only arrivals before t); None = grid
    # boundaries only (the pre-existing behavior)
    load_resolve_threshold: Optional[float] = None
    load_probe_s: float = 60.0
    # failure recovery: when a scripted fault kills a replica, harvest its
    # unfinished requests (ReplicaSim.take_victims) and re-route them onto
    # the survivors/replacements at the failure boundary; the next re-solve
    # sees the shrunken fleet and boots replacements (boot carbon charged
    # like any scale-up). False = victims stay dead with status "killed" -
    # the availability baseline the chaos benchmark compares against
    recover: bool = True
    # deadline-aware relaxed scheduling: a relaxed-class request carrying
    # a deadline_s is run-anytime-before-T - in a dirty-grid window
    # (ci > defer_ci_threshold) or a window that just lost replicas to
    # faults, the controller DEFERS it instead of routing it, re-entering
    # it at the first clean/stable window its deadline still fits in
    # (re-entry at the window boundary, like drain handoffs). Off by
    # default: deferral changes schedules, so the legacy path stays
    # bit-exact
    defer_relaxed: bool = False
    defer_ci_threshold: float = 250.0

    def __post_init__(self):
        if self.boot_s < 0:
            raise ValueError(f"negative boot_s: {self.boot_s}")
        if not 0 < self.ewma_alpha <= 1:
            raise ValueError(f"ewma_alpha must be in (0, 1]: {self.ewma_alpha}")
        if self.slo_class is not None and self.slo_class not in SLO_CLASSES:
            raise ValueError(f"unknown slo_class: {self.slo_class!r} "
                             f"(one of {sorted(SLO_CLASSES)})")
        if self.load_resolve_threshold is not None \
                and self.load_resolve_threshold <= 0:
            raise ValueError("load_resolve_threshold must be > 0: "
                             f"{self.load_resolve_threshold}")
        if self.load_probe_s <= 0:
            raise ValueError(f"load_probe_s must be > 0: {self.load_probe_s}")


# ---------------------------------------------------------------------------
# Per-replica lifecycle record
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Replica:
    rid: int
    cfg: DisaggConfig
    sim: ReplicaSim
    reserve_start_s: float          # hardware held from here (boot begins)
    serve_start_s: float            # reserve_start + boot_s (sim.start_s)
    drain_mark_s: Optional[float] = None
    retired_s: Optional[float] = None

    @property
    def active(self) -> bool:
        return self.drain_mark_s is None


@dataclasses.dataclass(frozen=True)
class ReplicaSpan:
    """One replica's simulation plus its hardware reservation window."""

    rid: int
    cfg: DisaggConfig
    result: SimResult
    reserve_start_s: float
    retired_s: float

    def reserved(self) -> SimResult:
        """The result re-windowed to the reservation span, so the stock
        `SimResult.account(include_idle=True)` charges idle power and
        embodied amortization for every reserved second (boot included)."""
        return dataclasses.replace(self.result,
                                   start_s=self.reserve_start_s,
                                   duration_s=self.retired_s)


@dataclasses.dataclass
class AutoscaleResult:
    """Autoscaled run: per-replica spans + exact merged aggregate."""

    spans: list[ReplicaSpan]
    merged: SimResult
    windows: list[dict]             # per-window controller log

    def slo_attainment(self, ds: Dataset) -> float:
        return self.merged.slo_attainment(ds)

    @property
    def total_tokens(self) -> int:
        return self.merged.total_tokens

    def peak_instances(self) -> int:
        return max((w["instances"] for w in self.windows), default=0)

    def boots(self) -> int:
        return sum(w["boots"] for w in self.windows)

    def drains(self) -> int:
        return sum(w["drains"] for w in self.windows)

    def deaths(self) -> int:
        return sum(w.get("deaths", 0) for w in self.windows)

    def recovered(self) -> int:
        return sum(w.get("recovered", 0) for w in self.windows)

    def account(self, ci: "float | CarbonTrace",
                lifetimes: Optional[dict[str, float]] = None,
                include_idle: bool = True) -> CarbonBreakdown:
        """Total carbon: per-replica busy segments priced on the trace,
        idle/boot + embodied over each replica's own reservation span
        (include_idle=True is the honest mode for autoscaling - an idle
        reserved instance is exactly what scaling down eliminates)."""
        total = CarbonBreakdown.zero()
        for span in self.spans:
            total = total + span.reserved().account(
                ci, lifetimes=lifetimes, include_idle=include_idle)
        return total

    def carbon_per_token(self, ci: "float | CarbonTrace",
                         include_idle: bool = True) -> float:
        return self.account(ci, include_idle=include_idle).total_g / \
            max(self.total_tokens, 1)

    def describe(self) -> str:
        return " | ".join(
            f"[{w['t0']:.0f},{w['t1']:.0f})s ci={w['ci']:.0f} "
            f"rate={w['rate']:.1f}: " +
            (" + ".join(f"{k}x {n}" for n, k in sorted(w['counts'].items()))
             or "(empty)")
            for w in self.windows)


# ---------------------------------------------------------------------------
# ci-affine gpu_info: profiles are built once and re-priced per window
# ---------------------------------------------------------------------------
class _AffineProfiles:
    """`build_gpu_info` output as an affine function of grid intensity.

    Throughputs are CI-independent; fixed and dynamic carbon are affine in
    CI (embodied + idle*ci, energy*ci). Building the expensive engine
    profiles once and re-pricing per window keeps the controller's
    re-solve cost proportional to the solver, not the profiler."""

    def __init__(self, catalog: Sequence[DisaggConfig], dataset: Dataset,
                 buckets: SizeBuckets, utilization: Optional[float],
                 batching=None, slo_class: Optional[str] = None):
        self._at0 = build_gpu_info(catalog, dataset, buckets, ci=0.0,
                                   utilization=utilization, include_idle=True,
                                   batching=batching, slo_class=slo_class)
        self._at1 = build_gpu_info(catalog, dataset, buckets, ci=1.0,
                                   utilization=utilization, include_idle=True,
                                   batching=batching, slo_class=slo_class)

    def at(self, ci: float) -> dict[str, InstanceProfile]:
        out = {}
        for name, p0 in self._at0.items():
            p1 = self._at1[name]
            fixed = p0.carbon_fixed_g_per_hour + ci * (
                p1.carbon_fixed_g_per_hour - p0.carbon_fixed_g_per_hour)
            dyn = tuple(
                tuple(a + ci * (b - a) for a, b in zip(r0, r1))
                for r0, r1 in zip(p0.carbon_per_request_g,
                                  p1.carbon_per_request_g))
            out[name] = dataclasses.replace(
                p0, carbon_fixed_g_per_hour=fixed, carbon_per_request_g=dyn)
        return out


def _window_bounds(trace: CarbonTrace, t_end: float,
                   min_window_s: float) -> list[float]:
    """[0, ...trace boundaries..., t_end], short windows merged forward."""
    bounds = [0.0]
    for t in trace.times_s:
        if 0.0 < t < t_end and t - bounds[-1] >= min_window_s:
            bounds.append(t)
    if t_end - bounds[-1] < min_window_s and len(bounds) > 1:
        bounds.pop()
    bounds.append(t_end)
    return bounds


def _load_change_bounds(arrivals_s: "list[float]", bounds: "list[float]",
                        threshold: float, probe_s: float,
                        min_window_s: float) -> "list[float]":
    """Insert re-solve boundaries inside grid windows where the observed
    load shifts: walk each window in `probe_s` ticks and split when the
    newest probe slice's arrival rate leaves (1 +/- threshold) x the rate
    seen since the last boundary. Causal - the decision at tick t reads
    only arrivals in [t - probe_s, t), all observed by t."""
    out = [bounds[0]]
    for w0, w1 in zip(bounds, bounds[1:]):
        last = w0
        t = w0 + probe_s
        while t + 1e-9 < w1:
            n_seg = bisect.bisect_left(arrivals_s, t) \
                - bisect.bisect_left(arrivals_s, last)
            n_probe = bisect.bisect_left(arrivals_s, t) \
                - bisect.bisect_left(arrivals_s, t - probe_s)
            r_seg = n_seg / (t - last)
            r_probe = n_probe / probe_s
            shifted = abs(r_probe - r_seg) > threshold * r_seg \
                if r_seg > 0 else r_probe > 0
            if shifted and t - last >= min_window_s \
                    and w1 - t >= min_window_s:
                out.append(t)
                last = t
            t += probe_s
        out.append(w1)
    return out


def drain_victims(disp: OnlineDispatcher, candidates: "list[_Replica]",
                  count: int) -> "list[_Replica]":
    """Pick `count` replicas to drain, emptiest first.

    Emptiest compares the PER-CLASS backlog vector (tight level first),
    not the scalar worst-level `busy_until`: two replicas can tie on
    total backlog while only one holds the tight-class queue, and
    draining that one would stall tight traffic behind the drain while
    the other sits on relaxed bulk any survivor could absorb. Ties break
    on replica id for determinism. Single-class fleets (every vector a
    constant) reduce exactly to the old scalar ordering."""
    victims = sorted(candidates,
                     key=lambda r: (tuple(disp._busy_class[r.rid]), r.rid))
    return victims[:count]


def _split_fault_script(faults) -> "tuple[dict, dict, dict]":
    """Split a fault script (FaultTrace or FaultEvent iterable) into the
    controller's view. `ev.replica` indexes replicas in BOOT ORDER (the
    controller rid): the script shoots at fleet slots, and an event whose
    time passes before that slot has booted is a no-op.

    Returns (kill_at, notice_at, stall_by_rid):
      kill_at      rid -> earliest hard-kill time (kill at_s, or preempt
                   at_s + notice_s); later kill events on an already-dead
                   rid are ignored
      notice_at    rid -> preemption-notice open time (the replica stops
                   taking traffic and starts draining here)
      stall_by_rid rid -> stall events, handed to the replica's own
                   injector at boot (time dilation only - no controller
                   action needed)
    """
    best: dict[int, object] = {}
    stall_by_rid: dict[int, list] = {}
    for ev in faults:
        if ev.kind == "stall":
            stall_by_rid.setdefault(ev.replica, []).append(ev)
            continue
        cur = best.get(ev.replica)
        if cur is None or ev.effective_kill_s < cur.effective_kill_s:
            best[ev.replica] = ev
    kill_at: dict[int, float] = {}
    notice_at: dict[int, float] = {}
    for rid, ev in best.items():
        kill_at[rid] = ev.effective_kill_s
        if ev.kind == "preempt" and ev.at_s < ev.effective_kill_s:
            notice_at[rid] = ev.at_s
    return kill_at, notice_at, stall_by_rid


def _reenter(req: Request, w0: float) -> Request:
    """Re-anchor a recovered request at the boundary `w0`. Lifecycle
    bounds that already expired while the request was stranded on its
    dead replica collapse to an immediate cancellation at re-entry, so
    the survivor aborts it at admission and it is still accounted exactly
    once (an expired deadline surfaces as status "cancelled" here - the
    timeout fired while no scheduler owned the request)."""
    deadline = req.deadline_s
    cancel = req.cancel_at_s
    if deadline is not None and deadline <= w0:
        deadline, cancel = None, w0
    if cancel is not None and cancel < w0:
        cancel = w0
    return dataclasses.replace(req, arrival_s=w0,
                               deadline_s=deadline, cancel_at_s=cancel)


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------
def simulate_autoscaled(
    catalog: Sequence[DisaggConfig],
    dataset: Dataset,
    requests: Sequence[Request],
    trace: CarbonTrace,
    policy: AutoscalePolicy = AutoscalePolicy(),
    buckets: Optional[SizeBuckets] = None,
    seed: int = 0,
    rate_estimator: str = "oracle",
    faults=None,
) -> AutoscaleResult:
    """Serve `requests` with a fleet re-allocated at every grid window.

    Per window [t0, t1): the window's arrival rate and size distribution
    and the window's mean grid intensity feed `allocate(...)` with
    `prev_counts` (running replicas are boot-free) and the policy's
    inventory/boot terms; the fleet is reconciled to the solution
    (boot/drain), the window's arrivals are routed online, and every
    replica advances to the boundary. Deterministic for fixed inputs:
    routing is deterministic and replica seeds derive from `seed` + boot
    order.

    `rate_estimator` picks the window-rate forecast the solver sees:

      oracle       - the window's true arrival rate (and its true size
                     distribution): the clairvoyant upper bound
      last_window  - the previous window's *observed* rate; sizes from
                     the cumulative history. The first window (nothing
                     observed yet) falls back to the oracle rate.
      ewma         - exponentially weighted moving average of observed
                     window rates (`policy.ewma_alpha` on the newest),
                     same fallbacks as last_window.

    Forecasts are floored at one request per window once traffic has been
    seen: a zero forecast would deprovision the whole fleet and strand
    every arrival of a mispredicted window.

    `faults` (FaultTrace or FaultEvent iterable, `ev.replica` = controller
    rid in boot order) injects scripted failures the controller must ride
    through. Every kill/notice time becomes an extra re-solve boundary -
    a failure window is treated exactly like a load-resolve window:

      kill     the replica dies at the boundary (steps already begun
               finish, matching `ReplicaSim.advance_to` kill-splitting);
               with `policy.recover` its unfinished requests are
               harvested (`take_victims`) and re-routed onto survivors at
               the boundary, and the same window's re-solve sees the
               shrunken fleet and boots a replacement, charged boot
               carbon like any scale-up. Without recovery the victims
               stay dead with status "killed".
      preempt  a spot reclaim: at `at_s` the replica stops taking traffic
               and drains (its untouched backlog is reclaimed
               immediately); whatever is still in flight races the hard
               kill at `at_s + notice_s`.
      stall    handed to the replica's own injector at boot - transient
               slowdown (time dilation), no controller action.

    Events aimed at a rid that has not booted by the event time, or
    timed past the last window boundary, are no-ops."""
    if rate_estimator not in ("oracle", "last_window", "ewma"):
        raise ValueError(f"unknown rate_estimator: {rate_estimator!r}")
    reqs = sorted(requests, key=lambda r: (r.arrival_s, r.req_id))
    if not reqs:
        raise ValueError("no requests to serve")
    if buckets is None:
        buckets = SizeBuckets.from_dataset(dataset)
    batching = resolve_batch_policy(policy.batching,
                                    default=FLEET_BATCHING_DEFAULT)
    profiles = _AffineProfiles(catalog, dataset, buckets, policy.utilization,
                               batching, slo_class=policy.slo_class)
    by_name = {c.name: c for c in catalog}
    ctx_estimate = int(np.mean([r.prompt_len + r.output_len for r in reqs]))

    t_end = reqs[-1].arrival_s + 1e-9
    bounds = _window_bounds(trace, t_end, policy.min_window_s)
    if policy.load_resolve_threshold is not None:
        bounds = _load_change_bounds(
            [r.arrival_s for r in reqs], bounds,
            policy.load_resolve_threshold, policy.load_probe_s,
            policy.min_window_s)
    kill_at: dict[int, float] = {}
    notice_at: dict[int, float] = {}
    stall_by_rid: dict[int, list] = {}
    if faults is not None:
        kill_at, notice_at, stall_by_rid = _split_fault_script(faults)
        # failure instants are re-solve boundaries, never merged away
        fault_times = {t for t in (*kill_at.values(), *notice_at.values())
                       if 0.0 < t < bounds[-1]}
        if fault_times:
            bounds = sorted(set(bounds) | fault_times)

    disp = make_dispatcher(batching=batching)
    replicas: dict[int, _Replica] = {}
    next_rid = 0
    windows: list[dict] = []
    i_req = 0
    ewma_rate: Optional[float] = None       # EWMA of observed window rates
    prev_rate: Optional[float] = None       # last window's observed rate
    deferred: list[Request] = []            # relaxed deadline-jobs on hold

    for w0, w1 in zip(bounds, bounds[1:]):
        window_s = w1 - w0
        ci_w = resolve_ci(trace, w0, w1)
        # --- fault handling at the boundary -----------------------------
        deaths = notices = 0
        recovered: list[Request] = []
        # preemption notices due: the replica stops taking traffic and
        # drains; its untouched backlog is reclaimed now, while whatever
        # is in flight races the scheduled hard kill
        for rid in [r for r, t in notice_at.items() if t <= w0]:
            del notice_at[rid]
            rep = replicas.get(rid)
            if rep is None or not rep.active or rep.retired_s is not None:
                continue
            rep.drain_mark_s = w0
            disp.remove(rid)
            notices += 1
            if policy.recover:
                recovered.extend(rep.sim.reclaim_pending())
        # hard kills due: every step that began before w0 already ran
        # (previous window's advance), mirroring advance_to kill-splitting
        for rid in [r for r, t in kill_at.items() if t <= w0]:
            del kill_at[rid]
            rep = replicas.get(rid)
            if rep is None or rep.retired_s is not None or rep.sim.dead:
                continue
            if rep.active:
                rep.drain_mark_s = w0
                disp.remove(rid)
            rep.sim.kill(w0)
            deaths += 1
            if policy.recover:
                recovered.extend(rep.sim.take_victims())
            rep.retired_s = max(w0, rep.sim.result().duration_s)
        # --- window estimates ------------------------------------------
        j = i_req
        while j < len(reqs) and reqs[j].arrival_s < w1:
            j += 1
        arrivals = reqs[i_req:j]
        rate = len(arrivals) / window_s
        if rate_estimator == "oracle" or prev_rate is None:
            rate_est = rate
        elif rate_estimator == "last_window":
            rate_est = prev_rate
        else:                                # ewma
            rate_est = ewma_rate
        if rate_est <= 0 and (i_req > 0 or recovered):
            # minimum-capacity floor; recovered victims are real demand
            # even when the window itself brings no fresh arrivals
            rate_est = max(1.0, float(len(recovered))) / window_s
        # --- re-solve the allocation for this window -------------------
        active = [r for r in replicas.values() if r.active]
        prev_counts: dict[str, int] = {}
        for r in active:
            prev_counts[r.cfg.name] = prev_counts.get(r.cfg.name, 0) + 1
        if arrivals or recovered \
                or (rate_est > 0 and rate_estimator != "oracle"):
            info_w = profiles.at(ci_w)
            boot_g = policy.boot_carbon_g
            if boot_g is None:
                # a boot wastes at least its own reservation: boot_s at
                # the dirtiest profile's fixed (embodied + idle) rate
                boot_g = max(p.carbon_fixed_g_per_hour
                             for p in info_w.values()) * policy.boot_s / 3600.0
            # inventory is a *physical* cap: chips still reserved by
            # draining (not yet retired) replicas are unavailable to this
            # window's solve
            inv = policy.inventory
            if inv is not None:
                held: dict[str, int] = {}
                for r in replicas.values():
                    if not r.active and r.retired_s is None:
                        for c in r.cfg.mode.chips():
                            held[c] = held.get(c, 0) + 1
                if held:
                    inv = {c: max(k - held.get(c, 0), 0)
                           for c, k in inv.items()}
            # size distribution: the oracle sees the window's own mix; a
            # forecaster only knows the history observed so far
            if rate_estimator == "oracle" or i_req == 0:
                dist = bucket_workload(arrivals, buckets)
            else:
                dist = bucket_workload(reqs[:i_req], buckets)
            alloc = allocate(dist, rate_est, info_w,
                             slice_factor=policy.slice_factor,
                             inventory=inv,
                             prev_counts=prev_counts,
                             boot_carbon_g=boot_g,
                             window_s=window_s)
        else:
            alloc = Allocation({}, {}, 0.0, True, {})
        # --- reconcile: boot up / drain down ---------------------------
        boots = drains = 0
        victims_w: list[_Replica] = []
        for name in sorted(set(alloc.counts) | set(prev_counts)):
            target = alloc.counts.get(name, 0)
            have = prev_counts.get(name, 0)
            for _ in range(target - have):
                reserve = max(w0 - policy.boot_s, 0.0) if policy.proactive \
                    else w0
                sim = ReplicaSim(by_name[name].mode, by_name[name].target,
                                 draft_cfg=by_name[name].draft,
                                 seed=seed + next_rid,
                                 ctx_estimate=ctx_estimate,
                                 start_s=reserve + policy.boot_s,
                                 batching=batching,
                                 faults=stall_by_rid.get(next_rid))
                rep = _Replica(next_rid, by_name[name], sim,
                               reserve_start_s=reserve,
                               serve_start_s=reserve + policy.boot_s)
                replicas[next_rid] = rep
                disp.add(next_rid, rep.cfg, ready_s=rep.serve_start_s)
                next_rid += 1
                boots += 1
            if have > target:
                victims = drain_victims(
                    disp, [r for r in active
                           if r.cfg.name == name and r.active],
                    have - target)
                for r in victims:
                    r.drain_mark_s = w0
                    disp.remove(r.rid)
                    drains += 1
                victims_w.extend(victims)
        # hand the victims' untouched backlog to the capacity that booted
        # this same window (a type switch); on a pure scale-down the
        # victims drain their own backlog in parallel instead - rerouting
        # it onto fewer survivors only serializes the tail
        handoff: list[Request] = []
        if policy.drain_handoff and boots:
            for r in victims_w:
                handoff.extend(r.sim.reclaim_pending())
        # failure victims always re-route: unlike a voluntary drain, a
        # dead replica cannot finish its own backlog
        handoff.extend(recovered)
        # --- deadline-aware relaxed deferral ----------------------------
        # re-enter held jobs once the grid is clean and the fleet stable
        # again, or when a job's deadline no longer survives another
        # window of waiting (every held job has deadline_s > w0, so
        # re-entry at the boundary never violates deadline > arrival)
        deferred_in = 0
        if deferred:
            flush = ci_w <= policy.defer_ci_threshold and deaths == 0
            last_window = w1 >= bounds[-1]
            still: list[Request] = []
            for req in deferred:
                if flush or last_window or req.deadline_s <= w1:
                    handoff.append(req)
                    deferred_in += 1
                else:
                    still.append(req)
            deferred = still
        # --- route this window's arrivals online -----------------------
        pools: dict[tuple[int, int], list[int]] = {}
        for bucket, shares in alloc.assignment.items():
            pool = [r.rid for n, rt in sorted(shares.items()) if rt > 0
                    for r in replicas.values()
                    if r.active and r.cfg.name == n]
            if pool:
                pools[bucket] = sorted(pool)
        everyone = sorted(r.rid for r in replicas.values() if r.active)
        if (arrivals or handoff) and not everyone:
            raise ValueError(
                f"window [{w0}, {w1}): arrivals but no active replica - "
                f"inventory limits too tight? (alloc={alloc.counts}, "
                f"unplaced={alloc.unplaced_rate:.3g} req/s)")
        # drain handoff first: reclaimed backlog re-enters at the drain
        # boundary (w0 >= every prior submission, so each survivor's
        # arrival stream stays sorted) and lands on whatever the
        # dispatcher now deems least loaded - typically the replacement
        # that just booted for this window
        handoff.sort(key=lambda r: (r.arrival_s, r.req_id))
        for req in handoff:
            req = _reenter(req, w0)
            pool = pools.get(buckets.index(req.prompt_len, req.output_len),
                             everyone)
            rid = disp.pick(req, pool or everyone)
            replicas[rid].sim.submit(req)
        deferrals = 0
        for req in arrivals:
            # a relaxed deadline-job is run-anytime-before-T: hold it out
            # of a dirty-grid or failure window while a later window can
            # still meet its deadline
            if policy.defer_relaxed and req.slo_class == "relaxed" \
                    and req.deadline_s is not None \
                    and (ci_w > policy.defer_ci_threshold or deaths) \
                    and req.deadline_s > w1 and w1 < bounds[-1]:
                deferred.append(req)
                deferrals += 1
                continue
            pool = pools.get(buckets.index(req.prompt_len, req.output_len),
                             everyone)
            rid = disp.pick(req, pool or everyone)
            replicas[rid].sim.submit(req)
        i_req = j
        # --- advance every live engine to the boundary -----------------
        for r in replicas.values():
            if r.retired_s is not None:
                continue
            r.sim.advance_to(w1)
            if r.active:
                disp.sync(r.rid, r.sim.clock)
            elif r.sim.idle:
                r.retired_s = max(r.drain_mark_s, r.sim.result().duration_s)
        windows.append({
            "t0": w0, "t1": w1, "ci": ci_w, "rate": rate,
            "rate_est": rate_est,
            "counts": dict(alloc.counts), "boots": boots, "drains": drains,
            "handoffs": len(handoff),
            "instances": sum(alloc.counts.values()),
            "alloc_feasible": alloc.feasible,
            "unplaced_rate": alloc.unplaced_rate,
            "boot_g": alloc.boot_g,
            "deaths": deaths, "preempt_notices": notices,
            "recovered": len(recovered),
            "deferrals": deferrals, "deferred_in": deferred_in,
        })
        # estimator state: fold in this window's *observed* rate
        prev_rate = rate
        ewma_rate = rate if ewma_rate is None else (
            policy.ewma_alpha * rate + (1.0 - policy.ewma_alpha) * ewma_rate)

    # --- run out the backlog ------------------------------------------
    for r in replicas.values():
        if r.retired_s is None:
            r.sim.drain()
    fleet_end = max((r.sim.result().duration_s for r in replicas.values()),
                    default=t_end)
    fleet_end = max(fleet_end, bounds[-1])
    spans = []
    for r in replicas.values():
        if r.retired_s is None:
            # drained-at-end replicas retire when their own backlog ends;
            # still-active ones hold hardware until the fleet winds down
            end = max(r.drain_mark_s, r.sim.result().duration_s) \
                if r.drain_mark_s is not None else fleet_end
            r.retired_s = end
        spans.append(ReplicaSpan(r.rid, r.cfg, r.sim.result(),
                                 r.reserve_start_s, r.retired_s))
    spans.sort(key=lambda s: s.rid)
    if not spans:
        raise ValueError("controller provisioned no replicas")
    merged = SimResult.merge([s.result for s in spans])
    return AutoscaleResult(spans, merged, windows)
