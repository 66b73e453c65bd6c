"""Event-driven cluster simulator for disaggregated serving.

Simulates the four GreenLLM serving configurations (§7.1) over Poisson
request streams, with latencies/energies from the analytic roofline model
(perfmodel.py) and chip specs from core/carbon.py:

  standalone - target model alone on the new chip
  spec       - colocated speculative decoding on the new chip
  dpd        - Disg-Pref-Decode: prefill on new, decode on old, KV cache
               shipped across the interconnect (link modeled as a FIFO
               resource - saturation at high QPS reproduces the paper's
               Fig. 4 bandwidth wall)
  dsd        - Disg-Spec-Decode: draft on old, target+verifier on new,
               token ids + draft probs cross the link; the Fig. 7
               communication-overlap schedule hides the probs transfer
               behind the target forward

The executor is the steppable `ReplicaSim`: submit requests, `advance_to`
a horizon, read live state, keep going - the carbon-aware autoscaler
(serving/autoscale.py) drives one per replica and boots/drains them at
grid-intensity window boundaries. `simulate()` wraps it for the classic
submit-everything-then-drain runs; both paths execute the identical event
loop, pinned bit-exactly by tests/test_parity_golden.py.

Two scheduler policies (serving/batching.py), selected per engine via
`batching=`:

  serialized  - the legacy loop: prefills run one whole prompt at a time
                with priority over decode, admission by a one-shot KV cap
                (`ReplicaSim.cap`), decode rounds priced at the batch-mean
                context. Bit-exact against tests/data/golden_simulate.json.
  continuous  - vLLM/Sarathi-style iteration-level batching: every step is
                a hybrid batch of prefill *chunks* + decode tokens under a
                per-step token budget, KV admission/preemption is
                block-granular (BlockLedger mirrors the engine's
                PagedKVPool), and decode KV traffic is summed per sequence
                (exact roofline). The default for fleet/autoscale runs.

Modeling notes (documented deltas from a hardware run):
 - speculative acceptance is sampled per request per round from the
   geometric acceptance model with measured/profiled rate `acceptance`
   (the real-compute engine in serving/engine.py measures it end-to-end);
 - admission control by KV-cache HBM capacity (perfmodel.max_concurrency);
 - iterations are non-preemptive: `advance_to(t)` runs every step that
   *begins* before `t`; a step spanning `t` completes past it.

Carbon accounting runs *after* simulation (`account()`), so sweeps over
carbon intensity and lifetime (Figs. 14-15) reuse one simulation.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.carbon import (
    CHIP_DB,
    CarbonBreakdown,
    CarbonTrace,
    DEFAULT_CI,
    request_carbon,
    resolve_ci,
)
from repro_torch.distributed.fault import make_injector
from repro_torch.models.config import ModelConfig
from repro_torch.serving.batching import (
    BatchPolicy,
    BlockLedger,
    ContinuousScheduler,
    DpdReadyQueue,
    OutOfBlocks,
    SchedSeq,
    build_dpd_decode_ledger,
    build_dpd_prefill_scheduler,
    build_single_pool_scheduler,
    dpd_resume_kv,
    plan_dpd_decode_step,
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
from repro_torch.serving.perfmodel import (
    Interconnect,
    decode_cost,
    max_concurrency,
)
from repro_torch.serving.prefix_cache import request_block_keys
from repro_torch.serving.workload import Dataset, Request, class_priority, slo_targets


@dataclasses.dataclass(frozen=True)
class ServingMode:
    """One column of the scheduler's configuration matrix."""

    name: str
    kind: str                        # standalone | spec | dpd | dsd
    new_chip: str = "a100"
    old_chip: Optional[str] = None
    spec_k: int = 4
    acceptance: float = 0.8
    interconnect: Interconnect = Interconnect()
    overlap_comm: bool = True
    max_batch: int = 64

    def chips(self) -> list[str]:
        return [self.new_chip] + ([self.old_chip] if self.old_chip else [])


@dataclasses.dataclass
class ReqTrace:
    req: Request
    ttft_s: float = math.nan
    finish_s: float = math.nan
    tokens_out: int = 0
    first_token_s: float = math.nan
    last_token_s: float = math.nan
    # lifecycle outcome: "ok" (finished or still pending), or the abort
    # reason - "cancelled" (client cancel), "timed_out" (deadline passed),
    # "killed" (replica died). Exactly one status per request; an aborted
    # request keeps the tokens/charges it accrued (partial work stays
    # charged once - the no-double-charge accounting rule).
    status: str = "ok"

    @property
    def tpot_s(self) -> float:
        if self.tokens_out <= 1:
            return 0.0
        return (self.last_token_s - self.first_token_s) / (self.tokens_out - 1)

    def slo_ok(self, ds: Dataset) -> bool:
        """Against the request's own class targets (workload.SLO_CLASSES;
        the default "standard" class is exactly the dataset's Table-2
        targets, so single-class accounting is unchanged)."""
        ttft, tpot = slo_targets(ds, self.req.slo_class)
        return self.ttft_s <= ttft and self.tpot_s <= tpot


@dataclasses.dataclass
class ChipUse:
    busy_s: float = 0.0
    energy_j: float = 0.0
    # (start_s, end_s, energy_j) per charged step, on the simulation clock -
    # the timeline `account()` integrates against a CarbonTrace. Aggregates
    # above stay authoritative; segments are additive detail.
    segments: list[tuple[float, float, float]] = dataclasses.field(default_factory=list)
    # distinct physical chips behind this entry (>1 after SimResult.merge)
    instances: int = 1

    def add(self, start_s: float, cost) -> None:
        self.busy_s += cost.time_s
        self.energy_j += cost.energy_j
        self.segments.append((start_s, start_s + cost.time_s, cost.energy_j))

    def merged_with(self, other: "ChipUse") -> "ChipUse":
        return ChipUse(self.busy_s + other.busy_s,
                       self.energy_j + other.energy_j,
                       sorted(self.segments + other.segments),
                       self.instances + other.instances)


@dataclasses.dataclass
class SimResult:
    mode: ServingMode
    traces: list[ReqTrace]
    use: dict[str, ChipUse]                  # chip name -> usage
    duration_s: float                        # absolute end time on the sim clock
    link_bytes: float = 0.0
    link_busy_s: float = 0.0
    start_s: float = 0.0                     # clock offset the engine booted at
    num_instances: int = 1                   # >1 after merge(): fleet aggregate

    @property
    def total_tokens(self) -> int:
        return sum(t.tokens_out for t in self.traces)

    def slo_attainment(self, ds: Dataset,
                       slo_class: Optional[str] = None,
                       include_aborted: bool = False) -> float:
        """Fraction of requests meeting their class targets; `slo_class`
        restricts to one class (None = all, the legacy aggregate).

        Aborted requests (cancelled / timed-out / killed) are accounted in
        `status_counts`, DISTINCT from SLO misses, so by default they leave
        the denominator - a cancelled request is not a latency failure.
        `include_aborted=True` is the stricter availability view (the chaos
        benchmarks use it): every abort counts as a miss."""
        traces = self.traces if slo_class is None else \
            [t for t in self.traces if t.req.slo_class == slo_class]
        if not include_aborted:
            traces = [t for t in traces if t.status == "ok"]
        done = [t for t in traces
                if t.status == "ok" and t.tokens_out >= t.req.output_len]
        if not traces:
            return 1.0
        return sum(t.slo_ok(ds) for t in done) / len(traces)

    def status_counts(self) -> dict[str, int]:
        """Requests per lifecycle outcome ("ok" = finished or pending).
        Every request appears exactly once - the chaos-accounting
        invariant (tests/test_chaos_property.py)."""
        out = {"ok": 0, "cancelled": 0, "timed_out": 0, "killed": 0}
        for t in self.traces:
            out[t.status] += 1
        return out

    @property
    def num_cancelled(self) -> int:
        return sum(1 for t in self.traces if t.status == "cancelled")

    @property
    def num_timed_out(self) -> int:
        return sum(1 for t in self.traces if t.status == "timed_out")

    @property
    def num_killed(self) -> int:
        return sum(1 for t in self.traces if t.status == "killed")

    def per_class_attainment(self, ds: Dataset) -> dict[str, float]:
        """SLO attainment per class present in the trace set."""
        classes = sorted({t.req.slo_class for t in self.traces})
        return {c: self.slo_attainment(ds, slo_class=c) for c in classes}

    def mean_ttft(self) -> float:
        v = [t.ttft_s for t in self.traces if not math.isnan(t.ttft_s)]
        return float(np.mean(v)) if v else math.nan

    def mean_tpot(self) -> float:
        v = [t.tpot_s for t in self.traces if t.tokens_out > 1]
        return float(np.mean(v)) if v else math.nan

    def peak_link_gbps(self) -> float:
        if self.link_busy_s <= 0:
            return 0.0
        return self.link_bytes * 8.0 / 1e9 / self.link_busy_s

    def account(self, ci: "float | CarbonTrace" = DEFAULT_CI,
                lifetimes: Optional[dict[str, float]] = None,
                include_idle: bool = False) -> CarbonBreakdown:
        """Total carbon of the run (Eq. 3).

        include_idle=False is the paper-faithful mode: Eq. 1 amortizes
        embodied carbon over request *execution* time and energy is the
        power measured during execution. include_idle=True is a stricter
        beyond-paper accounting where a reserved pool draws idle power and
        amortizes embodied carbon over the whole serving window - it
        penalizes low-duty-cycle disaggregation (see fig9 --strict and
        EXPERIMENTS.md §Beyond-paper).

        `ci` may be a scalar (gCO2/kWh) or a `CarbonTrace`: with a trace,
        each charged step's energy is priced at the grid intensity in
        effect while it ran (integrated over the step window), so the same
        simulation sweeps time-varying grids without re-simulating. A flat
        trace is numerically identical to the scalar path."""
        window_s = max(self.duration_s - self.start_s, 0.0)
        total = CarbonBreakdown.zero()
        for name, use in self.use.items():
            chip = CHIP_DB[name]
            lt = (lifetimes or {}).get(name)
            busy = use.busy_s
            occupancy = busy
            if isinstance(ci, CarbonTrace) and use.segments:
                op = sum(
                    ci.operational_g(e_j, t0, t1) for t0, t1, e_j in use.segments)
            else:
                op = request_carbon(
                    0.0, use.energy_j, chip,
                    ci_g_per_kwh=resolve_ci(ci, self.start_s, self.duration_s),
                ).operational_g
            idle_window = use.instances * window_s
            if include_idle and idle_window > busy:
                idle_e = chip.idle_power_w * (idle_window - busy)
                op += request_carbon(
                    0.0, idle_e, chip,
                    ci_g_per_kwh=resolve_ci(ci, self.start_s, self.duration_s),
                ).operational_g
                occupancy = idle_window
            total = total + CarbonBreakdown(
                operational_g=op,
                embodied_g=request_carbon(occupancy, 0.0, chip, lifetime_years=lt).embodied_g)
        return total

    def carbon_per_token(self, ci: "float | CarbonTrace" = DEFAULT_CI,
                         lifetimes: Optional[dict[str, float]] = None,
                         include_idle: bool = False) -> float:
        tok = max(self.total_tokens, 1)
        return self.account(ci, lifetimes, include_idle).total_g / tok

    @staticmethod
    def merge(results: "list[SimResult]") -> "SimResult":
        """Fleet aggregation: sum chip usage, concat traces, widest window.

        Carbon is additive under merge: `merge(rs).account(ci)` equals the
        sum of the parts for any scalar or trace `ci` with include_idle
        False (per-segment pricing only depends on each segment). Replicas
        of the same chip type are distinct physical chips; per-chip
        `ChipUse.instances` tracks the count so include_idle accounting
        still charges each reserved instance's idle window."""
        if not results:
            raise ValueError("merge() needs at least one SimResult")
        # accumulate in place and sort each chip's segments once at the
        # end: pairwise merged_with() re-sorts the growing list per fold,
        # which is quadratic in fleet size and dominates large merges
        use: dict[str, ChipUse] = {}
        for r in results:
            for name, u in r.use.items():
                if name in use:
                    agg = use[name]
                    agg.busy_s += u.busy_s
                    agg.energy_j += u.energy_j
                    agg.instances += u.instances
                    agg.segments.extend(u.segments)
                else:
                    use[name] = ChipUse(u.busy_s, u.energy_j,
                                        list(u.segments), u.instances)
        for agg in use.values():
            agg.segments.sort()
        traces = [t for r in results for t in r.traces]
        traces.sort(key=lambda t: t.req.arrival_s)
        return SimResult(
            mode=results[0].mode,
            traces=traces,
            use=use,
            duration_s=max(r.duration_s for r in results),
            link_bytes=sum(r.link_bytes for r in results),
            link_busy_s=sum(r.link_busy_s for r in results),
            start_s=min(r.start_s for r in results),
            num_instances=sum(r.num_instances for r in results),
        )


def _emit_round_tokens(rng: np.random.Generator, acceptance: float, k: int) -> int:
    """Sample #tokens emitted by one speculative round (geometric accept)."""
    n = 0
    while n < k and rng.random() < acceptance:
        n += 1
    return n + 1


class _Active:
    """A request in the decode batch."""

    __slots__ = ("trace", "ctx", "remaining")

    def __init__(self, trace: ReqTrace, ctx: int):
        self.trace = trace
        self.ctx = ctx                       # current context length
        self.remaining = trace.req.output_len - 1  # first token from prefill


class ReplicaSim:
    """Steppable single-replica engine simulator.

    Lifecycle: construct, `submit()` requests (non-decreasing arrivals),
    `advance_to(t)` repeatedly, `result()` for a snapshot at any point.
    `drain()` runs to completion - `simulate()` is exactly submit-all +
    drain, and reproduces the pre-refactor closure loops bit-exactly.

    Incremental contract: before `advance_to(t)`, every request arriving
    strictly before `t` must already be submitted - `advance_to` executes
    all steps *beginning* before `t`, and batching/admission decisions at
    those instants assume the arrival stream is complete up to them. The
    fleet autoscaler satisfies this by routing each grid window's arrivals
    before advancing replicas across it.

    Iterations are non-preemptive: a step that begins before `t` runs to
    completion even if it ends after `t` (the clock can overshoot the
    horizon; work never begins past it).
    """

    def __init__(
        self,
        mode: ServingMode,
        target_cfg: ModelConfig,
        draft_cfg: Optional[ModelConfig] = None,
        seed: int = 0,
        ctx_estimate: Optional[int] = None,
        start_s: float = 0.0,
        batching: "BatchPolicy | str | None" = None,
        ci_trace: Optional[CarbonTrace] = None,
        faults=None,
    ):
        if mode.kind in ("spec", "dsd") and draft_cfg is None:
            raise ValueError(f"{mode.kind} needs a draft model")
        if start_s < 0:
            raise ValueError(f"negative start_s: {start_s}")
        self.policy = resolve_batch_policy(batching, default="serialized")
        self.mode = mode
        self.target_cfg = target_cfg
        self.draft_cfg = draft_cfg
        self.start_s = start_s
        # grid-intensity trace for the prefix cache's carbon-aware
        # retention knob (policy.prefix_cache); carbon ACCOUNTING still
        # happens post-hoc in SimResult.account - this only modulates how
        # aggressively finished prompts' KV is retained
        self.ci_trace = ci_trace
        self.rng = np.random.default_rng(seed)
        self.new_chip = CHIP_DB[mode.new_chip]
        self.old_chip = CHIP_DB[mode.old_chip] if mode.old_chip else None
        self.use: dict[str, ChipUse] = {mode.new_chip: ChipUse()}
        if mode.old_chip:
            self.use[mode.old_chip] = self.use.get(mode.old_chip, ChipUse())
        self.traces: list[ReqTrace] = []
        self.link_bytes = 0.0
        self.link_busy_s = 0.0
        self._ctx_estimate = ctx_estimate
        self._cap: Optional[int] = None
        self._i_arrival = 0                       # next trace to admit
        # traces removed by reclaim_pending(): keeps continuous-path sids
        # (_i_arrival + _num_reclaimed) unique across removals
        self._num_reclaimed = 0
        # single-loop (standalone/spec/dsd) state
        self._t = start_s
        self._prefq: deque[ReqTrace] = deque()
        self._active: list[_Active] = []
        # dpd state: prefill pool clock, FIFO link, decode pool clock
        # (the serialized path keeps the FIFO `_ready` list; the
        # continuous path admits through the class-aware `_ready_q`)
        self._t_a = start_s
        self._t_b = start_s
        self._link_free = start_s
        self._ready: list[tuple[float, ReqTrace]] = []
        self._i_ready = 0
        # dpd continuous: class-aware pool-B admission across the KV link
        # (ships and reships enter ONE queue; tight > standard > relaxed,
        # aging per pool-B round - batching.DpdReadyQueue)
        self._ready_q = DpdReadyQueue(self.policy.age_steps)
        # continuous-policy state (built lazily, like `cap`)
        self._sched: Optional[ContinuousScheduler] = None   # single-pool
        self._sched_a: Optional[ContinuousScheduler] = None  # dpd prefill pool
        self._ledger_b: Optional[BlockLedger] = None         # dpd decode pool
        self._active_b: list[SchedSeq] = []
        # fault state (distributed/fault.py): the injector owns a DEDICATED
        # rng stream, so a zero-fault trace replays schedules bit-exactly
        self._fault = make_injector(faults, seed=seed)
        self._kill_s = self._fault.kill_s if self._fault else math.inf
        self.dead = False
        self.dead_s: Optional[float] = None
        # any submitted request carrying cancel_at_s/deadline_s flips this;
        # False skips the per-step expiry scans entirely (zero overhead on
        # legacy workloads)
        self._lifecycle = False

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> ReqTrace:
        """Queue one arrival. Arrivals must be non-decreasing in time."""
        if self.traces and req.arrival_s < self.traces[-1].req.arrival_s:
            raise ValueError(
                f"arrivals must be non-decreasing: {req.arrival_s} after "
                f"{self.traces[-1].req.arrival_s}")
        tr = ReqTrace(req)
        if req.cancel_at_s is not None or req.deadline_s is not None:
            self._lifecycle = True
        self.traces.append(tr)
        return tr

    def reclaim_pending(self) -> list[Request]:
        """Remove and return every submitted request this engine has done
        NO work for yet: nothing charged, no KV, no tokens, no scheduler
        blocks. The drain-handoff hook - the autoscaler reclaims a
        draining replica's untouched backlog and re-routes it onto the
        survivors/replacements instead of stalling it behind the drain.

        Reclaimable requests are (a) arrivals not yet pulled into the
        engine (`_i_arrival` tail), (b) serialized-path prompts queued in
        `_prefq` whose prefill has not begun, and (c) continuous-path
        sequences still in the scheduler's waiting line with zero prefill
        progress. Requests with any work done (in-flight chunks, shipped
        dpd KV, emitted tokens) stay and drain here. Afterwards this
        sim's traces, charges, and queues are exactly as if the reclaimed
        requests had never been submitted. Returned sorted by
        (arrival_s, req_id)."""
        traces = self.traces
        drop: set[int] = set(range(self._i_arrival, len(traces)))
        if self.policy.kind == "continuous":
            sched = self._sched_a if self.mode.kind == "dpd" else self._sched
            if sched is not None:
                pos = {id(tr): i for i, tr in enumerate(traces)}
                keep = []
                for seq in sched.waiting:
                    # waiting seqs hold no ledger blocks; zero prefill
                    # progress + zero tokens means untouched (a preempted
                    # seq resets prefilled but re-prefills from scratch,
                    # so it is equally untouched when tokenless)
                    if seq.prefilled == 0 and seq.payload.tokens_out == 0:
                        drop.add(pos[id(seq.payload)])
                    else:
                        keep.append(seq)
                sched.waiting[:] = keep
        elif self.mode.kind != "dpd":
            pos = {id(tr): i for i, tr in enumerate(traces)}
            keep_q: deque[ReqTrace] = deque()
            for tr in self._prefq:
                drop.add(pos[id(tr)])
            self._prefq = keep_q
        # serialized dpd prefills straight off the trace list (no queue
        # between admission and work), so only the un-admitted tail above
        # is reclaimable there
        if not drop:
            return []
        reclaimed = [traces[i].req for i in sorted(drop)]
        self._num_reclaimed += len(drop)
        self._i_arrival -= sum(1 for i in drop if i < self._i_arrival)
        self.traces = [tr for i, tr in enumerate(traces) if i not in drop]
        reclaimed.sort(key=lambda r: (r.arrival_s, r.req_id))
        return reclaimed

    # ------------------------------------------------------------- state
    @property
    def clock(self) -> float:
        """Current engine time (the furthest pool clock for dpd)."""
        if self.mode.kind == "dpd":
            return max(self._t_a, self._t_b)
        return self._t

    @property
    def pending(self) -> int:
        """Requests submitted and still awaiting service: unfinished AND
        not aborted (a cancelled/timed-out/killed request is resolved -
        nothing here will ever serve it again)."""
        return sum(1 for tr in self.traces
                   if math.isnan(tr.finish_s) and tr.status == "ok")

    @property
    def idle(self) -> bool:
        return self.pending == 0

    @property
    def cap(self) -> int:
        """Decode-batch admission cap (KV-capacity gated); lazy so the
        submit-then-drain path can derive ctx from the full request list."""
        if self._cap is None:
            ctx = self._ctx_estimate
            if ctx is None:
                ctx = int(np.mean([t.req.prompt_len + t.req.output_len
                                   for t in self.traces])) if self.traces else 512
            decode_chip = self.old_chip if self.mode.kind == "dpd" else self.new_chip
            cap = min(self.mode.max_batch,
                      max_concurrency(self.target_cfg, decode_chip, ctx))
            if self.draft_cfg is not None and self.mode.kind == "spec":
                # draft weights share the new chip's HBM
                cap = min(cap, max_concurrency(self.draft_cfg, self.new_chip, ctx))
            self._cap = max(cap, 1)
        return self._cap

    def _charge(self, chip_name: str, cost, at_s: float) -> None:
        self.use[chip_name].add(at_s, cost)

    # ------------------------------------------------------------- driving
    def advance_to(self, t_stop: float) -> "ReplicaSim":
        """Run every step that begins before `t_stop` (non-preemptive).

        A scripted kill inside the window splits it: everything beginning
        before the kill time runs and stays charged (exactly the
        non-preemptive `advance_to(kill_s)` semantics), then the replica
        dies - one rule for all four kinds and both policies, so the
        scalar sim, the vector core, and the engine agree on which steps
        a fault interrupts."""
        if self.dead:
            return self
        if self._kill_s < t_stop:
            self._advance_impl(self._kill_s)
            self.kill(self._kill_s)
            return self
        self._advance_impl(t_stop)
        return self

    def _advance_impl(self, t_stop: float) -> None:
        if self.policy.kind == "continuous":
            if self.mode.kind == "dpd":
                self._advance_dpd_continuous(t_stop)
            else:
                self._advance_continuous(t_stop)
        elif self.mode.kind == "dpd":
            self._advance_dpd(t_stop)
        else:
            self._advance_single(t_stop)

    def kill(self, at_s: float) -> None:
        """The replica dies NOW: every unfinished request is aborted with
        status "killed", scheduler blocks are freed through the ledger,
        retained prefix-cache nodes are shed (the HBM is gone with the
        node), and all queues empty. Charges already written stay written
        - a killed request keeps its partial energy exactly once. The
        autoscale controller calls this directly; scripted `FaultEvent`s
        route here via `advance_to`."""
        if self.dead:
            return
        self.dead = True
        self.dead_s = at_s
        # clocks cannot run backwards: death at an idle instant moves them
        # forward to it, death mid-overshoot leaves the overshoot
        self._t = max(self._t, at_s)
        self._t_a = max(self._t_a, at_s)
        self._t_b = max(self._t_b, at_s)
        if self.policy.kind == "continuous":
            sched = self._sched_a if self.mode.kind == "dpd" else self._sched
            if sched is not None:
                for seq in (list(sched.running) + list(sched.prefilling)
                            + list(sched.waiting)):
                    sched.abort(seq)
                if sched.cache is not None:
                    sched.cache.shed()
            if self.mode.kind == "dpd":
                for seq in self._active_b:
                    self._ledger_b.free(seq.sid)
                self._active_b.clear()
                self._ready_q.purge(lambda item: True)
        else:
            self._prefq.clear()
            self._active.clear()
            self._i_ready = len(self._ready)
        for tr in self.traces:
            if math.isnan(tr.finish_s) and tr.status == "ok":
                tr.status = "killed"

    def take_victims(self) -> list[Request]:
        """Remove the killed traces and return their requests for
        re-routing (the recovery path). The dead replica keeps only the
        work it resolved - finished and cancelled/timed-out requests -
        so a fleet merge counts every request exactly once: either here
        (unrecovered, status "killed") or on the survivor that re-served
        it. Sorted by (arrival_s, req_id), like `reclaim_pending`."""
        if not self.dead:
            raise RuntimeError("take_victims() on a live replica")
        victims = [tr.req for tr in self.traces if tr.status == "killed"]
        if not victims:
            return []
        self._num_reclaimed += len(victims)
        self.traces = [tr for tr in self.traces if tr.status != "killed"]
        self._i_arrival = len(self.traces)
        victims.sort(key=lambda r: (r.arrival_s, r.req_id))
        return victims

    # ------------------------------------------------- lifecycle / stalls
    @staticmethod
    def _expired(req: Request, t: float) -> Optional[str]:
        """Abort reason for an unfinished request at scheduling point `t`
        (cancellation wins when both bounds have passed - the client gave
        up first in every tie we can order)."""
        if req.cancel_at_s is not None and req.cancel_at_s <= t:
            return "cancelled"
        if req.deadline_s is not None and req.deadline_s <= t:
            return "timed_out"
        return None

    def _expire_sched(self, sched: ContinuousScheduler, t: float) -> None:
        """Abort every expired sequence a continuous scheduler holds."""
        for seq in (list(sched.waiting) + list(sched.prefilling)
                    + list(sched.running)):
            st = self._expired(seq.payload.req, t)
            if st is not None:
                sched.abort(seq)
                seq.payload.status = st

    def _dilate(self, begin_s: float, base_s: float) -> float:
        """Wall-clock duration of a step beginning at `begin_s`: the one
        stall code path (FaultInjector.step_time over
        fault.apply_straggler_model). Identity without an injector or
        outside stall windows - charges are never dilated, only the
        clock, so a stalled chip waits without re-computing."""
        if self._fault is None:
            return base_s
        return self._fault.step_time(begin_s, base_s)

    def drain(self) -> "ReplicaSim":
        """Run until all submitted requests finish."""
        return self.advance_to(math.inf)

    def prefix_cache_stats(self) -> Optional[dict]:
        """Hit/eviction counters of the bound prefix cache (None when the
        policy has none, or no continuous scheduler was ever built)."""
        sched = self._sched or self._sched_a
        if sched is None or sched.cache is None:
            return None
        return sched.cache.stats()

    def result(self) -> SimResult:
        """Snapshot of everything simulated so far."""
        if self.mode.kind == "dpd":
            duration = max(self._t_a, self._t_b, self._link_free)
        else:
            duration = self._t
        return SimResult(self.mode, self.traces, self.use, duration,
                         self.link_bytes, self.link_busy_s,
                         start_s=self.start_s)

    # --------------------------------------------- standalone / spec / dsd
    def _advance_single(self, t_stop: float) -> None:
        """One serialized engine loop (prefill priority over decode)."""
        traces = self.traces
        while True:
            if self._t >= t_stop:
                return
            # admit arrivals up to current time
            while (self._i_arrival < len(traces)
                   and traces[self._i_arrival].req.arrival_s <= self._t):
                self._prefq.append(traces[self._i_arrival])
                self._i_arrival += 1
            if self._lifecycle:
                for tr in [t for t in self._prefq
                           if self._expired(t.req, self._t)]:
                    tr.status = self._expired(tr.req, self._t)
                    self._prefq.remove(tr)
                for a in [a for a in self._active
                          if self._expired(a.trace.req, self._t)]:
                    a.trace.status = self._expired(a.trace.req, self._t)
                    self._active.remove(a)
            if not self._prefq and not self._active:
                if self._i_arrival >= len(traces):
                    return                        # fully idle
                nxt = traces[self._i_arrival].req.arrival_s
                if nxt >= t_stop:
                    return                        # next work starts past horizon
                self._t = max(self._t, nxt)
                continue
            if self._prefq and len(self._active) < self.cap:
                self._step_prefill()
            else:
                self._step_decode_round()

    def _step_prefill(self) -> None:
        mode = self.mode
        tr = self._prefq.popleft()
        sched = prefill_charges(mode.kind, self.target_cfg, self.draft_cfg,
                                self.new_chip, self.old_chip, tr.req.prompt_len)
        for chip_name, cost, rel_s in sched.charges:
            self._charge(chip_name, cost, self._t + rel_s)
        self._t += self._dilate(self._t, sched.duration_s)
        tr.ttft_s = self._t - tr.req.arrival_s
        tr.first_token_s = tr.last_token_s = self._t
        tr.tokens_out = 1
        if tr.req.output_len > 1:
            self._active.append(_Active(tr, tr.req.prompt_len + 1))
        else:
            tr.finish_s = self._t

    def _step_decode_round(self) -> None:
        mode = self.mode
        active = self._active
        b = len(active)
        ctx = int(np.mean([a.ctx for a in active]))
        k = mode.spec_k
        if mode.kind == "standalone":
            c = decode_cost(self.target_cfg, self.new_chip, b, ctx)
            self._charge(self.new_chip.name, c, self._t)
            self._t += self._dilate(self._t, c.time_s)
            emitted = {id(a): 1 for a in active}
        else:
            # one speculative round, batched across requests (costs.py owns
            # the draft-sequential/target-verify pricing shared with the
            # real-compute engine)
            draft_chip, c_d, c_t = spec_round_charges(
                mode.kind, self.target_cfg, self.draft_cfg,
                self.new_chip, self.old_chip, b, ctx, k)
            self._charge(draft_chip.name, c_d, self._t)
            self._charge(self.new_chip.name, c_t, self._t + c_d.time_s)
            if mode.kind == "spec":
                round_t = spec_round_time(mode.kind, c_d, c_t,
                                          mode.interconnect, 0, 0)
            else:
                ids_b, probs_b = dsd_link_bytes(self.draft_cfg, b, k)
                round_t = spec_round_time(mode.kind, c_d, c_t,
                                          mode.interconnect, ids_b, probs_b,
                                          overlap=mode.overlap_comm)
                self.link_bytes += ids_b + probs_b
                self.link_busy_s += (mode.interconnect.transfer_time(ids_b)
                                     + mode.interconnect.transfer_time(probs_b))
            self._t += self._dilate(self._t, round_t)
            emitted = {
                id(a): min(_emit_round_tokens(self.rng, mode.acceptance, k),
                           a.remaining)
                for a in active
            }
        done = []
        for a in active:
            e = emitted[id(a)]
            a.trace.tokens_out += e
            a.trace.last_token_s = self._t
            a.ctx += e
            a.remaining -= e
            if a.remaining <= 0:
                a.trace.finish_s = self._t
                done.append(a)
        for a in done:
            active.remove(a)

    # ------------------------------------------------------------- dpd
    def _advance_dpd(self, t_stop: float) -> None:
        """Disg-Pref-Decode: pool A prefills, KV crosses the FIFO link,
        pool B decodes. The pools run on separate clocks; within one
        `advance_to` window pool A runs first, so pool B's admission scans
        a ready-list that is complete up to the horizon (ready times are
        monotone because the link is FIFO with positive latency)."""
        cfg = self.target_cfg
        mode = self.mode
        traces = self.traces
        # pool A: prefill pipeline + FIFO link
        while self._i_arrival < len(traces):
            tr = traces[self._i_arrival]
            if max(self._t_a, tr.req.arrival_s) >= t_stop:
                break
            if self._lifecycle:
                st = self._expired(tr.req, max(self._t_a, tr.req.arrival_s))
                if st is not None:
                    tr.status = st              # expired before prefill began
                    self._i_arrival += 1
                    continue
            self._t_a = max(self._t_a, tr.req.arrival_s)
            sched = prefill_charges(mode.kind, cfg, None,
                                    self.new_chip, self.old_chip,
                                    tr.req.prompt_len)
            for chip_name, cost, rel_s in sched.charges:
                self._charge(chip_name, cost, self._t_a + rel_s)
            self._t_a += self._dilate(self._t_a, sched.duration_s)
            tr.ttft_s = self._t_a - tr.req.arrival_s
            tr.first_token_s = tr.last_token_s = self._t_a
            tr.tokens_out = 1
            nbytes = dpd_kv_bytes(cfg, tr.req.prompt_len)
            tx = mode.interconnect.transfer_time(nbytes)
            start = max(self._t_a, self._link_free)
            self._link_free = start + tx
            self.link_bytes += nbytes
            self.link_busy_s += tx
            if tr.req.output_len > 1:
                self._ready.append((self._link_free, tr))
            else:
                tr.finish_s = self._t_a
            self._i_arrival += 1

        # pool B: continuous-batch decode over KV-arrived requests
        while self._i_ready < len(self._ready) or self._active:
            if self._t_b >= t_stop:
                return
            while (self._i_ready < len(self._ready)
                   and self._ready[self._i_ready][0] <= self._t_b
                   and len(self._active) < self.cap):
                tr = self._ready[self._i_ready][1]
                self._i_ready += 1
                if self._lifecycle:
                    st = self._expired(tr.req, self._t_b)
                    if st is not None:
                        tr.status = st       # expired waiting on the link
                        continue
                self._active.append(_Active(tr, tr.req.prompt_len + 1))
            if self._lifecycle:
                for a in [a for a in self._active
                          if self._expired(a.trace.req, self._t_b)]:
                    a.trace.status = self._expired(a.trace.req, self._t_b)
                    self._active.remove(a)
            if not self._active:
                if self._i_ready >= len(self._ready):
                    return                        # waiting on pool A / link
                nxt = self._ready[self._i_ready][0]
                if nxt >= t_stop:
                    return
                self._t_b = nxt
                continue
            b = len(self._active)
            ctx = int(np.mean([a.ctx for a in self._active]))
            c = decode_cost(cfg, self.old_chip, b, ctx)
            self._charge(self.old_chip.name, c, self._t_b)
            self._t_b += self._dilate(self._t_b, c.time_s)
            done = []
            for a in self._active:
                a.trace.tokens_out += 1
                a.trace.last_token_s = self._t_b
                a.ctx += 1
                a.remaining -= 1
                if a.remaining <= 0:
                    a.trace.finish_s = self._t_b
                    done.append(a)
            for a in done:
                self._active.remove(a)

    # ------------------------------------------------- continuous batching
    def _scheduler(self) -> ContinuousScheduler:
        """Single-pool hybrid scheduler (standalone/spec/dsd), lazy like
        `cap` so policy overrides stay explicit per construction. Built by
        the shared factory in batching.py, identically to the engine's."""
        if self._sched is None:
            self._sched = build_single_pool_scheduler(
                self.policy, self.mode.kind, self.mode.max_batch,
                self.mode.spec_k, self.target_cfg, self.draft_cfg,
                self.new_chip, ci_trace=self.ci_trace)
        return self._sched

    def _finish_prefill(self, seq: SchedSeq, sched: ContinuousScheduler,
                        at_s: float) -> None:
        """First token emitted off a completed prefill (fresh, not resumed)."""
        tr: ReqTrace = seq.payload
        tr.ttft_s = at_s - tr.req.arrival_s
        tr.first_token_s = tr.last_token_s = at_s
        tr.tokens_out = 1
        if sched.note_first_token(seq):
            tr.finish_s = at_s

    def _advance_continuous(self, t_stop: float) -> None:
        """Hybrid chunked-prefill + decode loop (standalone/spec/dsd).

        Each iteration asks the shared `ContinuousScheduler` for a
        `StepPlan` and prices it through the process-wide `HybridPricer`
        memo over `costs.hybrid_step_charges` - the same schedule the
        real-compute engine charges, so the two executors stay
        parity-comparable on this policy too. Decode contexts are summed
        per sequence (exact roofline), not batch-mean like the serialized
        path."""
        sched = self._scheduler()
        traces = self.traces
        mode = self.mode
        k = mode.spec_k
        pricer = shared_pricer(mode.kind, self.target_cfg, self.draft_cfg,
                               self.new_chip, self.old_chip, k=k,
                               interconnect=mode.interconnect,
                               overlap=mode.overlap_comm)
        while True:
            if self._t >= t_stop:
                return
            while (self._i_arrival < len(traces)
                   and traces[self._i_arrival].req.arrival_s <= self._t):
                tr = traces[self._i_arrival]
                keys = request_block_keys(tr.req, self.policy.block_size) \
                    if sched.cache is not None else ()
                sched.submit(SchedSeq(self._i_arrival + self._num_reclaimed,
                                      tr.req.prompt_len,
                                      tr.req.output_len, payload=tr,
                                      priority=class_priority(tr.req.slo_class),
                                      prefix_keys=keys,
                                      deadline_s=tr.req.deadline_s))
                self._i_arrival += 1
            if self._lifecycle:
                self._expire_sched(sched, self._t)
            if sched.cache is not None:
                sched.cache.now_s = self._t       # carbon lookup only
            plan = sched.next_plan()
            if plan is None:
                if self._i_arrival >= len(traces):
                    return                        # fully idle
                nxt = traces[self._i_arrival].req.arrival_s
                if nxt >= t_stop:
                    return
                self._t = max(self._t, nxt)
                continue
            hs = pricer.charges(plan.chunk_specs(), plan.decode_ctxs())
            for chip_name, cost, rel_s in hs.charges:
                self._charge(chip_name, cost, self._t + rel_s)
            if hs.link_ids_bytes or hs.link_probs_bytes:
                self.link_bytes += hs.link_ids_bytes + hs.link_probs_bytes
                self.link_busy_s += (
                    mode.interconnect.transfer_time(hs.link_ids_bytes)
                    + mode.interconnect.transfer_time(hs.link_probs_bytes))
            self._t += self._dilate(self._t, hs.duration_s)
            if sched.cache is not None:
                sched.cache.now_s = self._t       # publish at step-end time
            for ch in plan.chunks:
                if sched.complete_chunk(ch.seq, ch.tokens) \
                        and ch.seq.emitted == 0:
                    self._finish_prefill(ch.seq, sched, self._t)
            for seq in plan.decodes:
                if mode.kind == "standalone":
                    e = 1
                else:
                    e = min(_emit_round_tokens(self.rng, mode.acceptance, k),
                            seq.remaining)
                tr = seq.payload
                tr.tokens_out += e
                tr.last_token_s = self._t
                if sched.note_decode(seq, e):
                    tr.finish_s = self._t

    def _sched_a_pool(self) -> ContinuousScheduler:
        if self._sched_a is None:
            self._sched_a = build_dpd_prefill_scheduler(
                self.policy, self.mode.max_batch, self.target_cfg,
                self.new_chip, ci_trace=self.ci_trace)
        return self._sched_a

    def _ledger_b_pool(self) -> BlockLedger:
        if self._ledger_b is None:
            self._ledger_b = build_dpd_decode_ledger(
                self.policy, self.target_cfg, self.old_chip)
        return self._ledger_b

    def _advance_dpd_continuous(self, t_stop: float) -> None:
        """Disg-Pref-Decode under the continuous policy.

        Pool A batches the waiting prompts into shared prefill steps
        (weights read once per step; prompts longer than the token budget
        proceed in chunks), instead of the serialized one-prompt-at-a-time
        pipeline; finished prompts ship KV over the FIFO link exactly as
        before. Pool B admits KV-arrived sequences block-granularly
        against its own ledger by their *actual* cached bytes - denser
        than the serialized path's count-based `cap`, which silently
        overcommits HBM on long-context mixes - and decodes with
        per-sequence context sums. A sequence needs a new block only every
        `block_size` tokens, so under block pressure the step simply
        STALLS the boundary-crossing sequences for a round (oldest-first
        get the free blocks) until a finishing sequence releases blocks;
        only a fully wedged pool (zero free blocks, every active sequence
        at a boundary) preempts the youngest swap-style, re-shipping its
        KV over the FIFO link before re-admission."""
        cfg = self.target_cfg
        mode = self.mode
        traces = self.traces
        sched = self._sched_a_pool()
        # chunk-only keys price the new pool, decode-only keys the old pool;
        # both live in one "dpd" pricer (the key spaces are disjoint)
        pricer = shared_pricer("dpd", cfg, None, self.new_chip,
                               self.old_chip, interconnect=mode.interconnect)
        # pool A: chunked batched prefill + FIFO link
        while True:
            if self._t_a >= t_stop:
                break
            while (self._i_arrival < len(traces)
                   and traces[self._i_arrival].req.arrival_s <= self._t_a):
                tr = traces[self._i_arrival]
                # pool A only prefills: model each prompt as output_len=1
                # so prefill completion retires the sequence (and frees
                # its pool-A blocks - the KV ships to pool B; retirement
                # also PUBLISHES the prompt into pool A's prefix cache,
                # where the next turn's prefill will match)
                keys = request_block_keys(tr.req, self.policy.block_size) \
                    if sched.cache is not None else ()
                sched.submit(SchedSeq(self._i_arrival + self._num_reclaimed,
                                      tr.req.prompt_len, 1,
                                      payload=tr,
                                      priority=class_priority(tr.req.slo_class),
                                      prefix_keys=keys,
                                      deadline_s=tr.req.deadline_s))
                self._i_arrival += 1
            if self._lifecycle:
                self._expire_sched(sched, self._t_a)
            if sched.cache is not None:
                sched.cache.now_s = self._t_a     # carbon lookup only
            plan = sched.next_plan()
            if plan is None:
                if self._i_arrival >= len(traces):
                    break
                nxt = traces[self._i_arrival].req.arrival_s
                if nxt >= t_stop:
                    break
                self._t_a = max(self._t_a, nxt)
                continue
            cost = pricer.charges(plan.chunk_specs(), ()).charges[0][1]
            self._charge(self.new_chip.name, cost, self._t_a)
            self._t_a += self._dilate(self._t_a, cost.time_s)
            if sched.cache is not None:
                sched.cache.now_s = self._t_a     # publish at step-end time
            for ch in plan.chunks:
                if not sched.complete_chunk(ch.seq, ch.tokens):
                    continue
                tr = ch.seq.payload
                tr.ttft_s = self._t_a - tr.req.arrival_s
                tr.first_token_s = tr.last_token_s = self._t_a
                tr.tokens_out = 1
                sched.note_first_token(ch.seq)     # retires the pool-A seq
                nbytes = dpd_kv_bytes(cfg, tr.req.prompt_len)
                tx = mode.interconnect.transfer_time(nbytes)
                start = max(self._t_a, self._link_free)
                self._link_free = start + tx
                self.link_bytes += nbytes
                self.link_busy_s += tx
                if tr.req.output_len > 1:
                    self._ready_q.push(self._link_free,
                                       class_priority(tr.req.slo_class),
                                       (tr, 1))
                else:
                    tr.finish_s = self._t_a

        # pool B: block-granular continuous decode over KV-arrived
        # requests, admitted class-first (DpdReadyQueue: tight > standard
        # > relaxed, aging per pool-B round, KV-arrival order within)
        ledger = self._ledger_b_pool()
        q = self._ready_q

        def reship(seq: SchedSeq) -> None:
            """Swap-style preemption: free the blocks now, pay the link to
            bring the sequence's KV back before re-admission.

            The transfer is priced on the link (bytes + busy seconds) but
            modeled contention-free with pool A's FIFO prefill shipments:
            the wedged pool idles while it waits either way, and pool A's
            schedule must stay independent of pool-B state so windowed
            `advance_to` equals a one-shot drain bit-exactly
            (tests/test_batching.py)."""
            ledger.free(seq.sid)
            self._active_b.remove(seq)
            nbytes = dpd_kv_bytes(cfg, seq.kv)
            tx = mode.interconnect.transfer_time(nbytes)
            self.link_bytes += nbytes
            self.link_busy_s += tx
            q.push(self._t_b + tx, seq.priority, (seq.payload, seq.emitted))

        while len(q) or self._active_b:
            if self._t_b >= t_stop:
                return
            if self._lifecycle:
                # queued (shipped-KV) entries hold no pool-B blocks; actives
                # free theirs through the ledger like any abort
                for tr, _ in q.purge(
                        lambda it: self._expired(it[0].req, self._t_b)):
                    tr.status = self._expired(tr.req, self._t_b)
                for seq in [s for s in self._active_b
                            if self._expired(s.payload.req, self._t_b)]:
                    seq.payload.status = self._expired(seq.payload.req,
                                                       self._t_b)
                    ledger.free(seq.sid)
                    self._active_b.remove(seq)
            while len(self._active_b) < mode.max_batch:
                entry = q.peek_eligible(self._t_b)
                if entry is None:
                    break
                tr, resume_emitted = entry[4]
                sid = tr.req.req_id
                kv0 = dpd_resume_kv(tr.req.prompt_len, resume_emitted)
                # watermark: keep one growth block per active sequence
                if ledger.blocks_needed(kv0) > \
                        ledger.free_blocks - len(self._active_b) - 1:
                    break                          # wait for blocks to free
                seq = SchedSeq(sid, tr.req.prompt_len, tr.req.output_len,
                               payload=tr,
                               priority=class_priority(tr.req.slo_class))
                seq.prefilled = seq.prefill_target
                seq.kv = kv0
                seq.emitted = resume_emitted
                ledger.allocate(sid, kv0)
                self._active_b.append(seq)
                q.pop(entry)
            if not self._active_b:
                if not len(q):
                    return                        # waiting on pool A / link
                blocked = q.peek_eligible(self._t_b)
                if blocked is not None:
                    tr, resume_emitted = blocked[4]
                    raise OutOfBlocks(
                        "dpd decode pool cannot fit one sequence (need "
                        f"{ledger.blocks_needed(tr.req.prompt_len + resume_emitted - 1)}"
                        f" blocks of {ledger.num_blocks})")
                nxt = q.next_ready_s()
                if nxt >= t_stop:
                    return
                self._t_b = nxt
                continue
            # block-pressure step composition (shared with the engine:
            # batching.plan_dpd_decode_step) - boundary-crossers get the
            # free blocks class-first, the rest stall this round
            stepping, victim = plan_dpd_decode_step(self._active_b, ledger)
            if not stepping:
                if victim is None:
                    raise OutOfBlocks(
                        f"dpd decode pool of {ledger.num_blocks} blocks "
                        f"cannot grow a single sequence "
                        f"(kv={self._active_b[0].kv})")
                # fully wedged: swap out the worst-class youngest
                reship(victim)
                continue
            ctxs = tuple(s.ctx for s in stepping)
            c = pricer.charges((), ctxs).charges[0][1]
            self._charge(self.old_chip.name, c, self._t_b)
            # aging credit for arrived entries this round kept waiting
            # (round START time: window-invariant - see DpdReadyQueue)
            q.note_round(self._t_b)
            self._t_b += self._dilate(self._t_b, c.time_s)
            done = []
            for seq in stepping:
                seq.emitted += 1
                seq.kv += 1
                ledger.extend_to(seq.sid, seq.kv)
                tr = seq.payload
                tr.tokens_out += 1
                tr.last_token_s = self._t_b
                if seq.remaining <= 0:
                    tr.finish_s = self._t_b
                    ledger.free(seq.sid)
                    done.append(seq)
            for seq in done:
                self._active_b.remove(seq)


def simulate(
    mode: ServingMode,
    target_cfg: ModelConfig,
    requests: list[Request],
    draft_cfg: Optional[ModelConfig] = None,
    seed: int = 0,
    ctx_estimate: Optional[int] = None,
    start_s: float = 0.0,
    batching: "BatchPolicy | str | None" = None,
    ci_trace: Optional[CarbonTrace] = None,
    faults=None,
) -> SimResult:
    """Simulate one engine over `requests` (arrival-sorted, absolute times).

    `start_s` is the engine's boot time on the shared fleet clock: nothing
    executes earlier, and arrivals before it queue until then. The fleet
    layer (serving/fleet.py) partitions one stream across replicas and
    calls this per replica, so request lists may be any subset of a
    workload as long as arrivals are non-decreasing.

    `batching` selects the scheduler policy: None/"serialized" is the
    legacy loop (bit-exact against tests/data/golden_simulate.json);
    "continuous" or a `BatchPolicy` enables iteration-level continuous
    batching with chunked prefill and block-granular KV admission
    (serving/batching.py) - the default for the fleet/autoscale layers.

    `ci_trace` feeds the prefix cache's carbon-aware retention when the
    policy enables `prefix_cache` (accounting stays post-hoc in
    `SimResult.account`).

    `faults` is this replica's slice of a `FaultTrace` (an iterable of
    `FaultEvent`s or a ready `FaultInjector`); kills/preemptions abort the
    in-flight work with "killed" status, stall windows dilate step times.
    None (the default) is the bit-exact legacy path.

    Thin wrapper: submit everything into a `ReplicaSim` and drain it."""
    sim = ReplicaSim(mode, target_cfg, draft_cfg=draft_cfg, seed=seed,
                     ctx_estimate=ctx_estimate, start_s=start_s,
                     batching=batching, ci_trace=ci_trace, faults=faults)
    for r in requests:
        sim.submit(r)
    return sim.drain().result()
