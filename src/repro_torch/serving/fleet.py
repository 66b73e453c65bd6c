"""Fleet layer: multi-instance heterogeneous serving over one request stream.

GreenLLM's scheduler (§4.3) picks *one* configuration per workload; serving
heavy traffic needs *fleets* - N replicas of possibly different (chip, mode)
instance types sharing a Poisson stream. This module simulates such fleets
by (1) routing each arrival to a replica with a deterministic dispatcher,
then (2) reusing the single-engine `simulate()` per replica on its
partition (arrivals keep their absolute times; replicas share one clock),
and (3) merging per-replica `SimResult`s with `SimResult.merge()` so fleet
carbon/SLO roll up exactly additively.

Routing policies:

  least_loaded   - each arrival goes to the replica whose estimated
                   completion of already-queued work (analytic perfmodel
                   service-time estimate) is earliest. The Mélange load
                   balancer's queue-aware policy, made deterministic for
                   simulation.
  bucketed       - Mélange-style size-aware routing: requests are bucketed
                   by (prompt, output) length and each bucket is pinned to
                   a subset of replicas (the allocator's assignment),
                   least-loaded within the subset. Keeps small-request
                   latency from hiding behind long-prompt head-of-line
                   blocking on the same instance.

Instance counts per type come from `core/allocator.py` (Mélange-style
min-carbon allocation); `FleetSpec.from_allocation` bridges the two.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Sequence

from repro_torch.core.carbon import CarbonBreakdown, CarbonTrace, DEFAULT_CI
from repro_torch.core.disagg import DisaggConfig
from repro_torch.core.spec_decode import expected_tokens_per_round
from repro_torch.serving.batching import (
    BatchPolicy,
    prompt_chunks,
    resolve_batch_policy,
)
from repro_torch.serving.costs import (
    dpd_kv_bytes,
    dsd_link_bytes,
    shared_pricer,
    spec_round_charges,
    spec_round_time,
)
from repro_torch.serving.perfmodel import decode_cost, prefill_cost
from repro_torch.serving.simulator import CHIP_DB, SimResult, simulate
from repro_torch.serving.workload import (
    NUM_PRIORITIES,
    Dataset,
    Request,
    class_priority,
)

# the fleet/autoscale layers run iteration-level continuous batching by
# default (serving/batching.py); pass batching="serialized" to the entry
# points below to reproduce the legacy stop-the-world-prefill fleets
FLEET_BATCHING_DEFAULT = "continuous"


# ---------------------------------------------------------------------------
# Fleet description
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReplicaGroup:
    """`count` identical instances of one serving configuration.

    `batching` overrides the fleet-level scheduler policy for this group
    only (None = inherit the `simulate_fleet(batching=...)` argument), so
    one fleet can mix serialized and continuous groups - e.g. legacy
    replicas running the stop-the-world loop next to migrated continuous
    ones. Routing weights stay on the fleet-level policy; the override
    selects the group's EXECUTOR."""

    config: DisaggConfig
    count: int
    batching: "BatchPolicy | str | None" = None

    def __post_init__(self):
        if self.count < 0:
            raise ValueError(f"negative replica count for {self.config.name}")


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """How many instances of each (chip, mode) configuration to provision."""

    groups: tuple[ReplicaGroup, ...]

    @staticmethod
    def of_counts(catalog: Sequence[DisaggConfig],
                  counts: dict[str, int]) -> "FleetSpec":
        """Build from {config-name: count} over a configuration catalog."""
        by_name = {c.name: c for c in catalog}
        unknown = set(counts) - set(by_name)
        if unknown:
            raise KeyError(f"configs not in catalog: {sorted(unknown)}")
        return FleetSpec(tuple(
            ReplicaGroup(by_name[n], k) for n, k in sorted(counts.items()) if k > 0))

    def replicas(self) -> list[DisaggConfig]:
        """Expanded per-instance list (group order, then instance index)."""
        return [g.config for g in self.groups for _ in range(g.count)]

    def replica_policies(self, default) -> "list[BatchPolicy]":
        """Per-instance resolved scheduler policy, honoring group
        overrides (parallel to `replicas()`)."""
        fleet_pol = resolve_batch_policy(default,
                                         default=FLEET_BATCHING_DEFAULT)
        return [fleet_pol if g.batching is None
                else resolve_batch_policy(g.batching)
                for g in self.groups for _ in range(g.count)]

    @property
    def total_count(self) -> int:
        return sum(g.count for g in self.groups)

    def counts(self) -> dict[str, int]:
        return {g.config.name: g.count for g in self.groups if g.count > 0}

    def chips(self) -> dict[str, int]:
        """Physical chip counts across the fleet (dpd/dsd use two chips)."""
        out: dict[str, int] = {}
        for g in self.groups:
            for chip in g.config.mode.chips():
                out[chip] = out.get(chip, 0) + g.count
        return out

    def describe(self) -> str:
        return " + ".join(f"{g.count}x {g.config.name}" for g in self.groups) or "(empty)"


# ---------------------------------------------------------------------------
# Analytic service-time estimate (dispatcher weight, not ground truth -
# the per-replica simulation is the ground truth)
# ---------------------------------------------------------------------------
def _estimate_continuous_s(cfg: DisaggConfig, prompt_len: int,
                           output_len: int, b: int,
                           policy: BatchPolicy) -> float:
    """Busy-time a request adds under iteration-level continuous batching.

    Prefill is the *marginal* cost of riding the prompt's chunks on hybrid
    steps that already carry `b` decode participants (standalone), or of
    budget-bounded dedicated prefill steps (spec/dsd/dpd, where decode
    slots are whole speculative rounds / a separate pool); decode is the
    per-request share of a `b`-wide hybrid round. This is the capacity
    frontier the continuous executor actually serves, so earliest-finish
    routing weights replicas by what they can really absorb."""
    mode = cfg.mode
    new_chip = CHIP_DB[mode.new_chip]
    old_chip = CHIP_DB[mode.old_chip] if mode.old_chip else None
    ctx = prompt_len + output_len // 2
    ctxs = (ctx,) * b
    chunks = prompt_chunks(prompt_len, policy.chunk_tokens)
    k = mode.spec_k
    if mode.kind == "dpd":
        # same pricer entries the executors populate: a profile grid or a
        # re-route prices off the fleet simulation's memo, not a fresh
        # roofline derivation per call
        pricer = shared_pricer("dpd", cfg.target, None, new_chip, old_chip,
                               interconnect=mode.interconnect)
        # pool A batches whole prompts under the step budget: amortize the
        # shared weight read over the prompts one step carries
        m = max(policy.token_budget // max(prompt_len, 1), 1)
        batched = prompt_chunks(prompt_len, policy.token_budget)
        pre = sum(pricer.charges(((c, s),) * m, ()).duration_s
                  for c, s in batched) / m
        tx = mode.interconnect.transfer_time(
            dpd_kv_bytes(cfg.target, prompt_len))
        dec = pricer.charges((), ctxs).duration_s / b
        return pre + tx + max(output_len - 1, 0) * dec
    pricer = shared_pricer(mode.kind, cfg.target, cfg.draft, new_chip,
                           old_chip, k=k, interconnect=mode.interconnect,
                           overlap=mode.overlap_comm)
    if mode.kind == "standalone":
        base = pricer.charges((), ctxs).duration_s
        pre = sum(pricer.charges((c,), ctxs).duration_s - base
                  for c in chunks)
        dec = base / b
        return pre + max(output_len - 1, 0) * dec
    # spec / dsd: prefill chunks get dedicated budget-bounded steps; a
    # decode slot is one whole speculative round (shared cost schedule)
    hs_pre = pricer.charges(chunks, ())
    hs_round = pricer.charges((), ctxs)
    e_tok = expected_tokens_per_round(mode.acceptance, k)
    rounds = max(output_len - 1, 0) / max(e_tok, 1.0)
    return hs_pre.duration_s + rounds * hs_round.duration_s / b


def estimate_service_s(cfg: DisaggConfig, prompt_len: int, output_len: int,
                       batch_hint: int = 8,
                       batching: "BatchPolicy | str | None" = None) -> float:
    """Rough busy-time a request adds to an instance of `cfg`.

    Uses the same perfmodel rooflines the simulator charges, at a nominal
    decode batch `batch_hint`, so relative weights across instance types
    are faithful even though absolute queueing is not modeled here.
    `batching` selects the scheduler policy the estimate models
    (default: the fleet's continuous policy)."""
    mode = cfg.mode
    policy = resolve_batch_policy(batching, default=FLEET_BATCHING_DEFAULT)
    b = max(batch_hint, 1)
    if policy.kind == "continuous":
        return _estimate_continuous_s(cfg, prompt_len, output_len, b, policy)
    new_chip = CHIP_DB[mode.new_chip]
    old_chip = CHIP_DB[mode.old_chip] if mode.old_chip else None
    ctx = prompt_len + output_len // 2
    pre = prefill_cost(cfg.target, new_chip, 1, prompt_len).time_s
    if mode.kind == "standalone":
        dec = decode_cost(cfg.target, new_chip, b, ctx).time_s / b
        return pre + max(output_len - 1, 0) * dec
    if mode.kind == "dpd":
        dec = decode_cost(cfg.target, old_chip, b, ctx).time_s / b
        # the prompt KV cache crosses the interconnect before decode can
        # start; without this term least-loaded routing systematically
        # under-weights dpd replicas (the link is often the binding
        # resource - Fig. 4)
        tx = mode.interconnect.transfer_time(dpd_kv_bytes(cfg.target, prompt_len))
        return pre + tx + max(output_len - 1, 0) * dec
    # spec / dsd: draft K+1 sequential steps + one target verify per round
    # (the shared cost schedule, so dispatcher weights track the simulator)
    k = mode.spec_k
    e_tok = expected_tokens_per_round(mode.acceptance, k)
    _, c_d, c_t = spec_round_charges(mode.kind, cfg.target, cfg.draft,
                                     new_chip, old_chip, b, ctx, k)
    if mode.kind == "spec":
        pre += prefill_cost(cfg.draft, new_chip, 1, prompt_len).time_s
        round_s = spec_round_time(mode.kind, c_d, c_t, mode.interconnect, 0, 0)
    else:
        # same Fig. 7 schedule the simulator prices: ids ship after the
        # draft, the probs transfer can hide behind the target forward
        ids_b, probs_b = dsd_link_bytes(cfg.draft, b, k)
        round_s = spec_round_time(mode.kind, c_d, c_t, mode.interconnect,
                                  ids_b, probs_b, overlap=mode.overlap_comm)
    rounds = max(output_len - 1, 0) / max(e_tok, 1.0)
    return pre + rounds * round_s / b


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SizeBuckets:
    """Mélange-style (prompt, output) length grid.

    `prompt_edges[i]` is the inclusive upper bound of prompt bucket i; the
    last bucket is open-ended (same for outputs)."""

    prompt_edges: tuple[int, ...]
    output_edges: tuple[int, ...]

    def __post_init__(self):
        for e in (self.prompt_edges, self.output_edges):
            if any(b <= a for a, b in zip(e, e[1:])):
                raise ValueError(f"edges must be strictly increasing: {e}")

    @property
    def shape(self) -> tuple[int, int]:
        return (len(self.prompt_edges) + 1, len(self.output_edges) + 1)

    def index(self, prompt_len: int, output_len: int) -> tuple[int, int]:
        i = sum(prompt_len > e for e in self.prompt_edges)
        j = sum(output_len > e for e in self.output_edges)
        return i, j

    def rep_size(self, i: int, j: int) -> tuple[int, int]:
        """Representative (prompt, output) size of bucket (i, j): its upper
        bound, or 1.5x the last edge for the open-ended tail."""
        def rep(edges: tuple[int, ...], k: int) -> int:
            if k < len(edges):
                return edges[k]
            return int(edges[-1] * 1.5) if edges else 1
        return rep(self.prompt_edges, i), rep(self.output_edges, j)

    @staticmethod
    def from_dataset(ds: Dataset) -> "SizeBuckets":
        """Grid at the dataset's P25/P50/P75 percentiles (Table 2)."""
        p_edges = tuple(sorted({ds.p25[0], ds.p50[0], ds.p75[0]}))
        o_edges = tuple(sorted({ds.p25[1], ds.p50[1], ds.p75[1]}))
        return SizeBuckets(p_edges, o_edges)


class OnlineDispatcher:
    """Deterministic earliest-finish dispatcher over a *live* replica set.

    One arrival at a time: `pick` routes a request to the replica whose
    estimated completion of already-routed work is earliest. Replicas can
    join (`add`, e.g. an autoscaler boot - `ready_s` models the boot
    penalty) and leave (`remove`, a drain) between arrivals, and `sync`
    floors a replica's backlog estimate at its simulator's actual clock so
    estimate drift never lets the dispatcher schedule into a replica's
    past. The offline `route_least_loaded`/`route_bucketed` partitioners
    and the autoscaler's window loop both run on this dispatcher, so
    static-fleet and autoscaled runs route identically.

    Routing is SLO-class aware: backlog is tracked per priority level, and
    a request's finish estimate counts only the backlog of its own class
    and better (the priority scheduler serves it ahead of more-relaxed
    work - serving/batching.py), while its own service time extends every
    equal-or-worse level. A tight arrival therefore prefers the replica
    with the least *tight* backlog even when relaxed bulk sits elsewhere;
    single-class streams reduce exactly to the scalar earliest-finish
    dispatcher.

    Routing is also session-STICKY: a multi-turn session's later turns
    re-land on the replica that served its first turn (its "home"),
    where the replica-local prefix cache holds the conversation's KV -
    a different replica would re-prefill the shared prefix from scratch.
    Stickiness yields only when the home is gone (drained) or its
    projected finish trails the best alternative by more than one
    service estimate of this request: at that point the re-prefill is
    cheaper than the queueing, and the session re-homes to the pick.
    Sessionless requests route exactly as before.
    """

    def __init__(self, batching: "BatchPolicy | str | None" = None):
        self.batching = resolve_batch_policy(batching,
                                             default=FLEET_BATCHING_DEFAULT)
        self.configs: dict[int, DisaggConfig] = {}
        # per-priority-level completion estimate: _busy_class[rid][p] is
        # when work of priority <= p (the backlog that precedes a class-p
        # arrival under priority scheduling) is expected to finish
        self._busy_class: dict[int, list[float]] = {}
        self._est_cache: dict[tuple[int, int, int], float] = {}
        # session id -> replica that holds its prefix KV (sticky routing)
        self._session_home: dict[int, int] = {}

    @property
    def busy_until(self) -> dict[int, float]:
        """All-class completion estimate per replica (the worst level) -
        derived, so it can never desync from the per-class state."""
        return {rid: lv[-1] for rid, lv in self._busy_class.items()}

    def add(self, rid: int, cfg: DisaggConfig, ready_s: float = 0.0) -> None:
        if rid in self.configs:
            raise ValueError(f"replica id {rid} already registered")
        self.configs[rid] = cfg
        self._busy_class[rid] = [ready_s] * NUM_PRIORITIES

    def remove(self, rid: int) -> None:
        cfg = self.configs.pop(rid)
        self._busy_class.pop(rid)
        # sessions homed here re-home on their next turn (the drained
        # replica's prefix cache is gone with it)
        self._session_home = {s: r for s, r in self._session_home.items()
                              if r != rid}
        # the estimate cache is keyed by config object identity; once no
        # registered replica holds this config, drop its entries so a
        # recycled id() of a *different* config can never serve them
        if not any(c is cfg for c in self.configs.values()):
            self._est_cache = {k: v for k, v in self._est_cache.items()
                               if k[0] != id(cfg)}

    def sync(self, rid: int, clock_s: float) -> None:
        """Floor a replica's backlog estimate at its engine's real clock."""
        self._busy_class[rid] = [max(v, clock_s)
                                 for v in self._busy_class[rid]]

    def _est(self, rid: int, req: Request) -> float:
        key = (id(self.configs[rid]), req.prompt_len, req.output_len)
        if key not in self._est_cache:
            self._est_cache[key] = estimate_service_s(
                self.configs[rid], req.prompt_len, req.output_len,
                batching=self.batching)
        return self._est_cache[key]

    def pick(self, req: Request,
             candidates: Optional[Sequence[int]] = None) -> int:
        """Route one arrival; returns the chosen replica id (ties break on
        iteration order of `candidates`, default all registered ids)."""
        p = class_priority(req.slo_class)
        ids = candidates if candidates is not None else sorted(self.configs)
        best, best_finish = None, None
        finishes: dict[int, float] = {}
        for rid in ids:
            finish = max(self._busy_class[rid][p], req.arrival_s) \
                + self._est(rid, req)
            finishes[rid] = finish
            if best_finish is None or finish < best_finish - 1e-12:
                best, best_finish = rid, finish
        if best is None:
            raise ValueError("cannot route onto an empty replica set")
        sid = getattr(req, "session_id", None)
        if sid is not None:
            home = self._session_home.get(sid)
            if home is not None and home in finishes and home != best:
                # prefix affinity: stay home unless the queueing penalty
                # exceeds one service estimate (the re-prefill bound)
                if finishes[home] - best_finish <= self._est(home, req):
                    best, best_finish = home, finishes[home]
            self._session_home[sid] = best
        busy = self._busy_class[best]
        start = max(busy[p], req.arrival_s)
        est = best_finish - start
        # the request EXTENDS every equal-or-worse level by its service
        # time (priority scheduling inserts it ahead of that backlog);
        # maxing with the finish instead would under-count relaxed
        # completion whenever relaxed backlog already exceeds it
        for q in range(p, NUM_PRIORITIES):
            busy[q] = max(busy[q], start) + est
        return best


class _HeapGroup:
    """All replicas sharing one config object: they share `_est`, so the
    within-group earliest-finish winner is the earliest-BUSY member."""

    __slots__ = ("cfg", "members", "busy_h", "idle_h")

    def __init__(self, cfg: DisaggConfig):
        self.cfg = cfg
        self.members: set[int] = set()
        # per priority level: lazy min-heaps of (busy, rid, ver) for members
        # still busy past the probe arrival, and (rid, ver) for idle ones
        self.busy_h: list[list] = [[] for _ in range(NUM_PRIORITIES)]
        self.idle_h: list[list] = [[] for _ in range(NUM_PRIORITIES)]


class HeapDispatcher(OnlineDispatcher):
    """O(log n)-per-arrival earliest-finish dispatcher (drop-in for the
    linear scan).

    The linear `pick` costs O(n) per arrival, so routing a 10k-replica
    fleet dominates simulation wall-clock. This subclass keeps
    `_busy_class` authoritative (every parent invariant and the session /
    priority semantics are inherited) but answers `pick` from per-
    (config-group, priority-level) heaps instead of scanning:

      * replicas sharing one config object form a group; within a group
        every member has the same service estimate, so the earliest-finish
        member is the min-rid IDLE member (busy <= arrival: finish is
        arrival + est for all of them) or else the min-(busy, rid) member.
      * each group keeps, per priority level, a busy-heap keyed (busy,
        rid) and an idle-heap keyed rid. Entries are version-stamped;
        state changes bump `_ver[rid][p]` and push a fresh entry, stale
        entries are discarded lazily on pop (classic lazy-deletion heap).
      * entries migrate busy->idle when the probe arrival passes their
        busy time, and idle->busy when a later probe's arrival is EARLIER
        (arrivals need not be monotone across autoscale windows), so the
        structure is correct for any arrival order.
      * across groups there are at most #configs candidates; the winner
        is chosen by replicating the linear scan's epsilon rule over the
        group winners in rid order.

    Decisions equal the linear scan's except when two finish estimates
    differ by a sub-epsilon (0, 1e-12] float-noise margin - strictly
    inside the tolerance band where the linear rule itself is an
    arbitrary path-dependent tie-break (tests/test_heap_dispatch.py pins
    empirical equality on seeded mixed-class + session workloads).
    """

    def __init__(self, batching: "BatchPolicy | str | None" = None):
        super().__init__(batching=batching)
        self._groups: dict[int, _HeapGroup] = {}
        self._group_of: dict[int, int] = {}
        self._ver: dict[int, list[int]] = {}
        # membership epoch: any add/remove invalidates pool decompositions
        self._epoch = 0
        # id(candidates) -> (epoch, candidates, full-group keys, partial
        # rids, member frozenset); holding `candidates` pins its id()
        self._pool_cache: dict[int, tuple] = {}

    # -- membership ---------------------------------------------------------
    def add(self, rid: int, cfg: DisaggConfig, ready_s: float = 0.0) -> None:
        super().add(rid, cfg, ready_s)
        gk = id(cfg)
        g = self._groups.get(gk)
        if g is None:
            g = self._groups[gk] = _HeapGroup(cfg)
        g.members.add(rid)
        self._group_of[rid] = gk
        self._ver[rid] = [0] * NUM_PRIORITIES
        for p in range(NUM_PRIORITIES):
            heapq.heappush(g.busy_h[p], (ready_s, rid, 0))
        self._epoch += 1
        self._pool_cache.clear()

    def remove(self, rid: int) -> None:
        gk = self._group_of.pop(rid)
        g = self._groups[gk]
        g.members.discard(rid)
        del self._ver[rid]  # orphans this rid's heap entries (lazily popped)
        if not g.members:
            del self._groups[gk]
        super().remove(rid)
        self._epoch += 1
        self._pool_cache.clear()

    # -- state updates ------------------------------------------------------
    def _bump(self, rid: int, p: int, busy_val: float) -> None:
        g = self._groups[self._group_of[rid]]
        v = self._ver[rid]
        v[p] += 1
        heapq.heappush(g.busy_h[p], (busy_val, rid, v[p]))

    def sync(self, rid: int, clock_s: float) -> None:
        busy = self._busy_class[rid]
        for p in range(NUM_PRIORITIES):
            if clock_s > busy[p]:
                busy[p] = clock_s
                self._bump(rid, p, clock_s)

    # -- candidate extraction -----------------------------------------------
    def _live(self, rid: int, p: int, ver: int) -> bool:
        v = self._ver.get(rid)
        return v is not None and v[p] == ver

    def _group_candidate(self, g: _HeapGroup, p: int,
                         arr: float) -> "tuple[int, float] | None":
        """(rid, start time) of the group's earliest-finish member."""
        bh, ih = g.busy_h[p], g.idle_h[p]
        # migrate members whose backlog clears before this arrival
        while bh:
            busy, rid, v = bh[0]
            if not self._live(rid, p, v):
                heapq.heappop(bh)
            elif busy <= arr:
                heapq.heappop(bh)
                heapq.heappush(ih, (rid, v))
            else:
                break
        # min-rid idle member, re-validated against THIS arrival (an
        # earlier-arriving probe may find a previously-idle member busy)
        while ih:
            rid, v = ih[0]
            if not self._live(rid, p, v):
                heapq.heappop(ih)
                continue
            busy = self._busy_class[rid][p]
            if busy > arr:
                heapq.heappop(ih)
                heapq.heappush(bh, (busy, rid, v))
                continue
            return rid, arr
        # no idle member: after migration every live busy entry has
        # busy > arr, so the heap top (min busy, then min rid) wins
        while bh:
            busy, rid, v = bh[0]
            if not self._live(rid, p, v):
                heapq.heappop(bh)
                continue
            return rid, busy
        return None

    def _resolve_pool(self, candidates: Sequence[int]):
        """Split a candidate pool into fully-covered groups + leftovers.

        Cached by pool object identity (offline routers and the autoscaler
        reuse one pool object across many arrivals) and invalidated on any
        membership change. Pools are treated as rid-ascending - every
        in-repo pool is - so the merged scan order matches the linear one.
        """
        key = id(candidates)
        hit = self._pool_cache.get(key)
        if hit is not None and hit[0] == self._epoch and hit[1] is candidates:
            return hit[2], hit[3], hit[4]
        rids = list(candidates)
        counts: dict[int, int] = {}
        for rid in rids:
            gk = self._group_of[rid]
            counts[gk] = counts.get(gk, 0) + 1
        full = tuple(gk for gk, c in counts.items()
                     if c == len(self._groups[gk].members))
        fullset = set(full)
        partial = tuple(r for r in rids if self._group_of[r] not in fullset)
        memb = frozenset(rids)
        self._pool_cache[key] = (self._epoch, candidates, full, partial, memb)
        return full, partial, memb

    # -- routing ------------------------------------------------------------
    def pick(self, req: Request,
             candidates: Optional[Sequence[int]] = None) -> int:
        p = class_priority(req.slo_class)
        arr = req.arrival_s
        if candidates is None:
            gks, partial, memb = tuple(self._groups), (), None
        else:
            gks, partial, memb = self._resolve_pool(candidates)
        cands: list[tuple[int, float]] = []
        for gk in gks:
            got = self._group_candidate(self._groups[gk], p, arr)
            if got is not None:
                rid, start0 = got
                cands.append((rid, max(start0, arr) + self._est(rid, req)))
        for rid in partial:
            cands.append((rid, max(self._busy_class[rid][p], arr)
                          + self._est(rid, req)))
        cands.sort()
        best, best_finish = None, None
        for rid, fin in cands:  # the linear scan's epsilon rule, rid order
            if best_finish is None or fin < best_finish - 1e-12:
                best, best_finish = rid, fin
        if best is None:
            raise ValueError("cannot route onto an empty replica set")
        sid = getattr(req, "session_id", None)
        if sid is not None:
            home = self._session_home.get(sid)
            in_pool = home is not None and (
                home in self.configs if memb is None else home in memb)
            if in_pool and home != best:
                home_fin = max(self._busy_class[home][p], arr) \
                    + self._est(home, req)
                if home_fin - best_finish <= self._est(home, req):
                    best, best_finish = home, home_fin
            self._session_home[sid] = best
        busy = self._busy_class[best]
        start = max(busy[p], arr)
        est = best_finish - start
        for q in range(p, NUM_PRIORITIES):
            busy[q] = max(busy[q], start) + est
            self._bump(best, q, busy[q])
        return best


DISPATCHERS = {"linear": OnlineDispatcher, "heap": HeapDispatcher}
# fleet entry points route via the heap core by default; it makes the same
# decisions as the linear scan (see HeapDispatcher) at O(log n) per arrival
FLEET_DISPATCHER_DEFAULT = "heap"


def make_dispatcher(dispatcher: "str | OnlineDispatcher | None" = None,
                    batching: "BatchPolicy | str | None" = None,
                    ) -> OnlineDispatcher:
    """Resolve a dispatcher selector: name, instance, or None (default)."""
    if isinstance(dispatcher, OnlineDispatcher):
        return dispatcher
    if dispatcher is None:
        dispatcher = FLEET_DISPATCHER_DEFAULT
    try:
        cls = DISPATCHERS[dispatcher]
    except KeyError:
        raise ValueError(f"unknown dispatcher: {dispatcher!r} "
                         f"(expected one of {sorted(DISPATCHERS)})") from None
    return cls(batching=batching)


def _fleet_dispatcher(fleet: FleetSpec, start_s: float,
                      batching=None, dispatcher=None) -> OnlineDispatcher:
    disp = make_dispatcher(dispatcher, batching=batching)
    for idx, cfg in enumerate(fleet.replicas()):
        disp.add(idx, cfg, ready_s=start_s)
    if not disp.configs:
        raise ValueError("cannot route onto an empty fleet")
    return disp


def route_least_loaded(requests: Sequence[Request], fleet: FleetSpec,
                       start_s: float = 0.0,
                       batching=None, dispatcher=None) -> list[list[Request]]:
    """Partition one arrival stream across all replicas, earliest-finish."""
    disp = _fleet_dispatcher(fleet, start_s, batching, dispatcher)
    parts: list[list[Request]] = [[] for _ in disp.configs]
    everyone = range(len(parts))
    for req in sorted(requests, key=lambda r: (r.arrival_s, r.req_id)):
        parts[disp.pick(req, everyone)].append(req)
    return parts


def route_bucketed(requests: Sequence[Request], fleet: FleetSpec,
                   buckets: SizeBuckets,
                   assignment: dict[tuple[int, int], Sequence[int]],
                   start_s: float = 0.0,
                   batching=None, dispatcher=None) -> list[list[Request]]:
    """Pin each size bucket to a replica subset; least-loaded within it.

    `assignment` maps bucket index (i, j) -> replica indices into
    `fleet.replicas()`. Buckets without an entry fall back to the whole
    fleet (so a coarse allocator assignment still routes everything)."""
    disp = _fleet_dispatcher(fleet, start_s, batching, dispatcher)
    n = len(disp.configs)
    for b, idxs in assignment.items():
        bad = [i for i in idxs if not 0 <= i < n]
        if bad or not idxs:
            raise ValueError(f"bucket {b}: bad replica indices {idxs}")
    parts: list[list[Request]] = [[] for _ in range(n)]
    everyone = tuple(range(n))
    for req in sorted(requests, key=lambda r: (r.arrival_s, r.req_id)):
        pool = assignment.get(buckets.index(req.prompt_len, req.output_len), everyone)
        parts[disp.pick(req, pool)].append(req)
    return parts


# ---------------------------------------------------------------------------
# Fleet simulation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FleetResult:
    """Per-replica simulations plus their exact aggregate."""

    fleet: FleetSpec
    replica_results: list[SimResult]
    partitions: list[list[Request]]
    merged: SimResult

    def slo_attainment(self, ds: Dataset) -> float:
        return self.merged.slo_attainment(ds)

    def account(self, ci: "float | CarbonTrace" = DEFAULT_CI,
                **kw) -> CarbonBreakdown:
        return self.merged.account(ci, **kw)

    def carbon_per_token(self, ci: "float | CarbonTrace" = DEFAULT_CI,
                         **kw) -> float:
        return self.merged.carbon_per_token(ci, **kw)

    @property
    def total_tokens(self) -> int:
        return self.merged.total_tokens

    def per_replica_tokens(self) -> list[int]:
        return [r.total_tokens for r in self.replica_results]


def _per_replica_faults(faults, n_replicas: int) -> list:
    """Normalize `faults` to one entry per fleet replica index.

    Accepts a `FaultTrace` (events carry `replica` indices on the fleet's
    expanded `replicas()` order) or an already per-replica sequence.
    Entries are None for fault-free replicas - those lanes stay on the
    bit-exact legacy path."""
    from repro_torch.distributed.fault import FaultTrace
    if isinstance(faults, FaultTrace):
        out: list = [None] * n_replicas
        for ev in faults:
            if ev.replica >= n_replicas:
                raise ValueError(
                    f"fault event targets replica {ev.replica} of a "
                    f"{n_replicas}-replica fleet")
            if out[ev.replica] is None:
                out[ev.replica] = []
            out[ev.replica].append(ev)
        return out
    faults = list(faults)
    if len(faults) != n_replicas:
        raise ValueError(
            f"per-replica faults must match the fleet "
            f"({n_replicas} replicas, got {len(faults)})")
    return faults


def simulate_fleet(
    fleet: FleetSpec,
    requests: Sequence[Request],
    policy: str = "least_loaded",
    buckets: Optional[SizeBuckets] = None,
    assignment: Optional[dict[tuple[int, int], Sequence[int]]] = None,
    seed: int = 0,
    start_s: float = 0.0,
    batching: "BatchPolicy | str | None" = None,
    core: str = "replica",
    dispatcher=None,
    rng_mode: str = "sequential",
    faults=None,
) -> FleetResult:
    """Route `requests` across the fleet, simulate each replica, merge.

    Deterministic for a fixed (fleet, requests, policy, seed): routing has
    no randomness and each replica gets a seed derived from its index.

    `batching` is the per-replica scheduler policy; the fleet default is
    iteration-level continuous batching (serving/batching.py) - pass
    "serialized" for the legacy stop-the-world-prefill executors.

    `core` selects the simulation backend: "replica" runs the per-replica
    Python event loop, "vector" runs `serving/vector_core.VectorFleetSim`
    (one lockstep numpy core per (config, policy) group - bit-exact with
    "replica" under rng_mode="sequential", orders of magnitude faster at
    fleet scale). Both the serialized and the continuous policy run
    vectorized; only `prefix_cache` continuous groups drop to the
    per-replica loop - grouping is on the full (config, batching) tuple,
    so a mixed fleet (per-group `ReplicaGroup.batching` overrides) routes
    each group to the right executor (see docs/scaling.md). `dispatcher`
    picks the routing core ("heap" default, "linear", or a pre-built
    OnlineDispatcher).

    `faults` injects replica failures (distributed/fault.py): a
    `FaultTrace` (events carry fleet replica indices) or a per-replica
    sequence of event iterables. Affected replicas abort their in-flight
    work with "killed" status at the scripted times - on the vector core
    those lanes delegate to the scalar event loop (chaos lanes), clean
    lanes keep the lockstep path. None is the bit-exact legacy path; for
    kill RECOVERY (victims re-routed, replacements booted) drive the
    autoscale controller instead (serving/autoscale.py)."""
    batching = resolve_batch_policy(batching, default=FLEET_BATCHING_DEFAULT)
    if core not in ("replica", "vector"):
        raise ValueError(f"unknown simulation core: {core!r}")
    lane_faults = _per_replica_faults(faults, fleet.total_count) \
        if faults is not None else None
    if policy == "least_loaded":
        parts = route_least_loaded(requests, fleet, start_s, batching,
                                   dispatcher)
    elif policy == "bucketed":
        if buckets is None or assignment is None:
            raise ValueError("bucketed routing needs buckets and assignment")
        parts = route_bucketed(requests, fleet, buckets, assignment, start_s,
                               batching, dispatcher)
    else:
        raise ValueError(f"unknown routing policy: {policy!r}")
    replicas = fleet.replicas()
    policies = fleet.replica_policies(batching)
    results: list[Optional[SimResult]] = [None] * len(replicas)
    if core == "vector":
        from repro_torch.serving.vector_core import VectorFleetSim
        # group on the full (config, policy) tuple: mixed fleets run each
        # group on its own lockstep executor. prefix_cache continuous
        # groups stay per-replica (the lockstep core does not bind a
        # radix cache) - they fall through to the scalar loop below.
        by_key: dict[tuple, list[int]] = {}
        for i, (cfg, pol) in enumerate(zip(replicas, policies)):
            if pol.kind == "continuous" and pol.prefix_cache:
                continue
            by_key.setdefault((id(cfg), pol), []).append(i)
        for (_cid, pol), idxs in by_key.items():
            cfg = replicas[idxs[0]]
            vf = VectorFleetSim(cfg.mode, cfg.target,
                                [parts[i] for i in idxs],
                                draft_cfg=cfg.draft,
                                seeds=[seed + i for i in idxs],
                                start_s=start_s, rng_mode=rng_mode,
                                batching=pol,
                                faults=[lane_faults[i] for i in idxs]
                                if lane_faults is not None else None)
            for lane, res in zip(idxs, vf.drain().results()):
                results[lane] = res
    for i, (cfg, part) in enumerate(zip(replicas, parts)):
        if results[i] is None:
            results[i] = simulate(cfg.mode, cfg.target, part,
                                  draft_cfg=cfg.draft,
                                  seed=seed + i, start_s=start_s,
                                  batching=policies[i],
                                  faults=lane_faults[i]
                                  if lane_faults is not None else None)
    return FleetResult(fleet, results, parts, SimResult.merge(results))
