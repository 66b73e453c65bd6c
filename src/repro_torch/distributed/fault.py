"""Fault tolerance utilities for the serving path.

`StragglerPolicy` implements deadline-based re-dispatch: an iteration that
exceeds `multiple x` its expected duration is assumed stuck (preempted
node, thermal throttle) and its work is re-issued to the backup pool; the
first result wins. The simulator applies it per decode iteration; a real
deployment applies it per pool RPC.

`HeartbeatTracker` is the liveness layer the elastic trainer consumes: a
pool that misses `miss_limit` heartbeats is declared failed, triggering
re-mesh (training/elastic.py) or pool eviction (serving router).

`FaultEvent`/`FaultTrace`/`FaultInjector` describe scripted failures that
both executors (ReplicaSim and ServingEngine) and the vector fleet core
consume.  Three kinds:

- ``kill``:    the replica dies at ``at_s``; every in-flight request is
               aborted (blocks freed, retained prefix-cache shed) and work
               already charged stays charged.
- ``preempt``: spot preemption with a notice window — the replica stops
               admitting at ``at_s`` and dies at ``at_s + notice_s``.  A
               standalone replica treats it as a delayed kill; the
               autoscale controller additionally drains during the notice.
- ``stall``:   for ``duration_s`` after ``at_s`` each step straggles with
               probability ``p_straggle`` (duration dilated by
               ``straggle_factor``, bounded by ``StragglerPolicy``
               mitigation).  Stalls stretch wall-clock only — the roofline
               busy/energy charge is unchanged (the chip is waiting, not
               re-computing), so energy monotonicity is preserved.

Semantics are aligned with the non-preemptive iteration model: faults take
effect at scheduling points, never mid-step, so a step that began before
the fault completes and its charge is kept exactly once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence

import numpy as np

_FAULT_RNG_TAG = 0x57A11  # dedicated stream: never perturbs acceptance rng


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    multiple: float = 3.0         # deadline = multiple x expected duration
    redispatch_overhead_s: float = 2e-3

    def deadline(self, expected_s: float) -> float:
        return self.multiple * expected_s

    def mitigate(self, actual_s: float, expected_s: float, backup_s: float) -> float:
        """Observed iteration time under the policy: when the primary blows
        its deadline, the re-dispatched backup bounds the tail."""
        d = self.deadline(expected_s)
        if actual_s <= d:
            return actual_s
        return d + self.redispatch_overhead_s + backup_s


@dataclasses.dataclass
class HeartbeatTracker:
    interval_s: float = 1.0
    miss_limit: int = 3
    _last: dict[str, float] = dataclasses.field(default_factory=dict)

    def beat(self, node: str, now_s: float) -> None:
        self._last[node] = now_s

    def dead(self, now_s: float) -> list[str]:
        limit = self.interval_s * self.miss_limit
        return [n for n, t in self._last.items() if now_s - t > limit]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault. ``replica`` is a fleet-level index; single-replica
    consumers ignore it (the caller slices the trace per replica first)."""
    at_s: float
    kind: str                    # "kill" | "preempt" | "stall"
    replica: int = 0
    notice_s: float = 0.0        # preempt: grace before the node vanishes
    duration_s: float = 0.0      # stall: window length
    p_straggle: float = 0.25     # stall: per-step straggle probability
    straggle_factor: float = 10.0

    def __post_init__(self):
        if self.kind not in ("kill", "preempt", "stall"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at_s < 0:
            raise ValueError("at_s must be >= 0")
        if self.notice_s < 0 or self.duration_s < 0:
            raise ValueError("notice_s/duration_s must be >= 0")
        if not (0.0 <= self.p_straggle <= 1.0):
            raise ValueError("p_straggle must be in [0, 1]")

    @property
    def effective_kill_s(self) -> float:
        """Time the replica actually vanishes (inf for stall events)."""
        if self.kind == "kill":
            return self.at_s
        if self.kind == "preempt":
            return self.at_s + self.notice_s
        return math.inf


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """An immutable, time-sorted script of faults for a fleet."""
    events: tuple = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events", tuple(sorted(self.events, key=lambda e: e.at_s)))

    def for_replica(self, idx: int) -> tuple:
        return tuple(e for e in self.events if e.replica == idx)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)


class FaultInjector:
    """Per-replica fault consumer.

    Holds the replica's slice of a `FaultTrace` plus a dedicated rng stream
    for stall sampling (isolated from the acceptance/workload streams, so a
    zero-fault trace replays schedules bit-exactly)."""

    def __init__(self, events: Iterable[FaultEvent] = (),
                 policy: Optional[StragglerPolicy] = None, seed: int = 0):
        evs = sorted(events, key=lambda e: e.at_s)
        self.events = tuple(evs)
        self.policy = policy if policy is not None else StragglerPolicy()
        kills = [e.effective_kill_s for e in evs if e.kind in ("kill", "preempt")]
        self.kill_s: float = min(kills) if kills else math.inf
        self._stalls = tuple(e for e in evs if e.kind == "stall")
        self._rng = np.random.default_rng((seed, _FAULT_RNG_TAG))

    def __bool__(self) -> bool:
        return bool(self.events)

    def notice_windows(self) -> list:
        """(notice_start_s, kill_s) per preempt event — controller use."""
        return [(e.at_s, e.effective_kill_s)
                for e in self.events if e.kind == "preempt"]

    def _stall_at(self, t: float) -> Optional[FaultEvent]:
        for e in self._stalls:
            if e.at_s <= t < e.at_s + e.duration_s:
                return e
        return None

    def step_time(self, at_s: float, base_s: float) -> float:
        """Wall-clock duration of a step that begins at ``at_s``.

        This is the single stall code path shared by both executors: the
        step's roofline charge (busy_s/energy_j) is priced as usual and the
        *clock* advances by the value returned here."""
        ev = self._stall_at(at_s)
        if ev is None:
            return base_s
        return apply_straggler_model(
            self._rng, base_s, self.policy,
            p_straggle=ev.p_straggle, straggle_factor=ev.straggle_factor)


def make_injector(faults, seed: int = 0,
                  policy: Optional[StragglerPolicy] = None):
    """Normalize a ctor arg: None | FaultInjector | iterable[FaultEvent]."""
    if faults is None:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultTrace):
        faults = faults.events
    evs: Sequence[FaultEvent] = tuple(faults)
    if not evs:
        return None
    return FaultInjector(evs, policy=policy, seed=seed)


def apply_straggler_model(
    rng, base_time_s: float, policy: StragglerPolicy,
    p_straggle: float = 0.0, straggle_factor: float = 10.0,
) -> float:
    """Sample an iteration duration under a straggler process bounded by the
    mitigation policy.  This is the one stall code path on the serving side:
    `FaultInjector.step_time` routes every executor's step timing through it
    (the backup pool re-serves at the primary's expected speed, so the
    re-dispatch bound is `deadline + overhead + base`)."""
    t = base_time_s
    if p_straggle > 0 and rng.random() < p_straggle:
        t = base_time_s * straggle_factor
    return policy.mitigate(t, base_time_s, base_time_s)
