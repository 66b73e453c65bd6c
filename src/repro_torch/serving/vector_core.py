"""Vectorized fleet simulation core: lockstep array stepping across replicas.

`ReplicaSim` (serving/simulator.py) advances one replica with a Python
event loop over per-request objects; at fleet scale (1k-10k replicas,
100k-1M requests) the interpreter overhead dominates wall clock. This
module re-executes the SAME serialized schedules as `ReplicaSim` - one
"event" (prefill admission, decode round, or idle jump) per replica per
lockstep iteration - but keeps all per-request state in flat numpy arrays
(phase via pointer/slot membership, context length, remaining tokens,
SLO-class priority) and all per-replica state in [R]-shaped arrays
(clocks, queue pointers, active-set sizes, chip busy/energy accumulators).

Bit-exactness strategy: every latency/energy number is produced by the
*existing scalar cost functions* (`prefill_charges`, `decode_cost`,
`spec_round_charges`, `spec_round_time`, `dpd_kv_bytes`) through a memo
keyed on the integer inputs that determine them (prompt length; (batch,
mean-context)). The vector core never re-derives a roofline formula, so
its floats are the scalar path's floats by construction; per-replica
accumulation (clock adds, busy/energy sums, link chains) happens in the
same operation order as the per-replica loop. `tests/test_vector_core.py`
pins `VectorFleetSim == ReplicaSim` with `==` (not approx) on all four
serving kinds, and `advance_to == drain` windowed parity.

Speculative RNG: `ReplicaSim` draws a *variable* number of uniforms per
request per round (`_emit_round_tokens`), which cannot be batched without
changing the draw sequence. Two modes:

  rng_mode="sequential"  per-replica `default_rng(seed_r)` drawn in active
                         order - bit-exact vs `ReplicaSim` (the default,
                         and what the parity tests run);
  rng_mode="batched"     one fleet-level generator draws a dense (n, k)
                         uniform block per round and takes the leading
                         accept run - statistically identical (same
                         truncated-geometric law per request), documented
                         non-bit-exact, and O(1) Python calls per step.
                         Use for 10k-replica-scale sweeps.

standalone/dpd schedules have no RNG at all, so both modes are bit-exact
there - the fleet_scale_sweep headline numbers are measured on that path.

The continuous policy (`batching="continuous"`, the fleet default) runs
in the same lockstep core: per-request scheduler scalars (prefill
target/progress, emitted, kv, held blocks, enqueue step) live in one
flat arena, the waiting/prefilling queues are per-lane lists, the
running set reuses the [R, C] slot arrays, and each lane's `BlockLedger`
collapses to one owned-block counter per pool (no prefix cache here, so
shared == retained == 0 and owned + free == num_blocks at every
iteration - `ledger_populations()` exposes the stacked populations for
the conservation property test). Steady pure-decode iterations - empty
queues, the whole running set in the decode slate, growth reserve
satisfied - are stepped as one vectorized batch priced through the
process-wide `HybridPricer` memo on the (n_dec, sum ctx) aggregate key;
every other lane runs a faithful per-lane port of
`ContinuousScheduler.next_plan` built from the same batching.py plan
arithmetic (blocks_for/chunk_take/growth_blocks/...), priced through the
SAME pricer entries the scalar executor populates. Plan selection is the
one irreducibly sequential piece; everything around it (pricing,
charging, decode bookkeeping, slot compaction) is arrays.
`prefix_cache` policies stay on the per-replica executor
(`simulate_fleet` routes those groups there). See docs/scaling.md.

All replicas in one `VectorFleetSim` share a (mode, target, draft) config;
heterogeneous fleets run one instance per config group
(`fleet.simulate_fleet(core="vector")` does the grouping).
"""
from __future__ import annotations

import math
from collections import namedtuple
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.carbon import CHIP_DB
from repro_torch.models.config import ModelConfig
from repro_torch.serving.batching import (
    BatchPolicy,
    DpdReadyQueue,
    OutOfBlocks,
    aged_priority,
    blocks_for,
    build_dpd_decode_ledger,
    build_dpd_prefill_scheduler,
    build_single_pool_scheduler,
    chunk_take,
    decode_slot_count,
    dpd_resume_kv,
    guard_cap_tokens,
    recompute_target,
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
    decode_cost,
    hybrid_step_key,
    max_concurrency,
)
from repro_torch.serving.simulator import (
    ChipUse,
    ReplicaSim,
    ReqTrace,
    ServingMode,
    SimResult,
    _emit_round_tokens,
)
from repro_torch.serving.workload import Request, class_priority

_CTX_BITS = 32
_CTX_MASK = (1 << _CTX_BITS) - 1

# continuous fast-path memo key: (n_dec << _A2_BITS) | sum(decode ctxs).
# 40 bits of context sum covers max_batch * max context with room to spare
# (64 * 10M tokens); n_dec <= max_batch fits the high bits.
_A2_BITS = 40
_A2_MASK = (1 << _A2_BITS) - 1

# frozen scheduler knobs of one continuous lane group, extracted ONCE from
# the shared batching.py builders so ledger sizing / decode_tokens /
# mix_decode can never drift from the scalar executor's scheduler
_Knobs = namedtuple("_Knobs", [
    "num_blocks", "chunk_tokens", "token_budget", "block_size",
    "age_steps", "max_batch", "decode_tokens", "mix_decode",
    "tpot_guard_frac",
])


def _gather(keys: np.ndarray, cache: dict, compute, width: int) -> np.ndarray:
    """Map an int64 key array through a scalar-compute memo, vectorized.

    One `compute` call per key never seen before; everything else is a
    unique+take. Returns float64 [len(keys), width]."""
    if len(keys) and keys[0] == keys[-1] and (keys == keys[0]).all():
        # constant-key round (fixed-size sweeps): skip the unique sort
        kv = int(keys[0])
        v = cache.get(kv)
        if v is None:
            v = compute(kv)
            cache[kv] = v
        return np.broadcast_to(np.asarray(v, dtype=np.float64),
                               (len(keys), width))
    uniq, inv = np.unique(keys, return_inverse=True)
    table = np.empty((len(uniq), width), dtype=np.float64)
    for i, kv in enumerate(uniq.tolist()):
        v = cache.get(kv)
        if v is None:
            v = compute(kv)
            cache[kv] = v
        table[i] = v
    return table[inv]


class VectorFleetSim:
    """Lockstep simulator for R replicas of ONE serving configuration.

    Construction takes the full per-replica request partitions up front
    (the `simulate()` contract: everything submitted, then advanced);
    `advance_to(t)` runs every step beginning before `t` on every lane,
    `drain()` runs to completion. `results()` materializes per-lane
    `SimResult`s (ReqTrace/ChipUse objects) for parity tests and merging;
    `stats()` summarizes straight from the arrays for benchmark-scale runs
    where materializing millions of objects would dominate.
    """

    def __init__(
        self,
        mode: ServingMode,
        target_cfg: ModelConfig,
        partitions: Sequence[Sequence[Request]],
        draft_cfg: Optional[ModelConfig] = None,
        seeds: Optional[Sequence[int]] = None,
        start_s: float = 0.0,
        rng_mode: str = "sequential",
        record_segments: bool = True,
        ctx_estimate: Optional[int] = None,
        batching: "BatchPolicy | str | None" = None,
        faults: Optional[Sequence] = None,
    ):
        if mode.kind in ("spec", "dsd") and draft_cfg is None:
            raise ValueError(f"{mode.kind} needs a draft model")
        if start_s < 0:
            raise ValueError(f"negative start_s: {start_s}")
        if rng_mode not in ("sequential", "batched"):
            raise ValueError(f"unknown rng_mode: {rng_mode!r}")
        self.policy = resolve_batch_policy(batching, default="serialized")
        if self.policy.kind == "continuous" and self.policy.prefix_cache:
            raise ValueError(
                "the lockstep continuous core does not run prefix_cache "
                "policies; use the per-replica executor for those")

        # chaos lanes: a lane with scripted faults (kill / preempt /
        # stall) or lifecycle-bearing requests (cancel_at_s / deadline_s)
        # delegates to an internal per-lane `ReplicaSim` - fault
        # interleavings run the scalar event loop, so the kill/expiry
        # semantics are THE scalar semantics by construction, while every
        # clean lane keeps the lockstep numpy path (zero-fault fleets are
        # bit-exact vs the pre-chaos core by construction). `faults` is a
        # per-lane sequence (None / FaultEvent iterable / FaultInjector).
        if faults is not None and len(faults) != len(partitions):
            raise ValueError(
                f"faults must be per-lane ({len(partitions)} lanes, got "
                f"{len(faults)})")
        self._chaos: dict[int, ReplicaSim] = {}
        chaos_lanes = set()
        for r, part in enumerate(partitions):
            lane_faults = faults[r] if faults is not None else None
            has_faults = lane_faults is not None and (
                not hasattr(lane_faults, "__len__") or len(lane_faults))
            lifecycle = any(req.cancel_at_s is not None
                            or req.deadline_s is not None for req in part)
            if has_faults or lifecycle:
                chaos_lanes.add(r)
        if chaos_lanes:
            if rng_mode == "batched":
                raise ValueError(
                    "chaos lanes (faults / request lifecycle bounds) need "
                    "rng_mode='sequential': the batched fleet rng draws "
                    "across lanes and cannot reproduce per-lane schedules")
            lane_seeds = list(seeds) if seeds is not None else \
                [0] * len(partitions)
            for r in sorted(chaos_lanes):
                sim = ReplicaSim(
                    mode, target_cfg, draft_cfg=draft_cfg,
                    seed=lane_seeds[r], ctx_estimate=ctx_estimate,
                    start_s=start_s, batching=self.policy,
                    faults=faults[r] if faults is not None else None)
                for req in partitions[r]:
                    sim.submit(req)
                self._chaos[r] = sim
            # delegated lanes run empty in the lockstep arrays; their
            # rows are stitched back in results()/stats()/pending
            partitions = [() if r in chaos_lanes else p
                          for r, p in enumerate(partitions)]
        self.mode = mode
        self.target_cfg = target_cfg
        self.draft_cfg = draft_cfg
        self.start_s = start_s
        self.rng_mode = rng_mode
        self.new_chip = CHIP_DB[mode.new_chip]
        self.old_chip = CHIP_DB[mode.old_chip] if mode.old_chip else None
        # chip accumulator columns (ReplicaSim.use key set, insertion order)
        names = [mode.new_chip]
        if mode.old_chip and mode.old_chip != mode.new_chip:
            names.append(mode.old_chip)
        self.chip_names = names
        self._old_ci = names.index(mode.old_chip) if mode.old_chip else 0

        R = len(partitions)
        self.R = R
        seeds = list(seeds) if seeds is not None else [0] * R
        if len(seeds) != R:
            raise ValueError("seeds must match the number of partitions")
        self._seeds = seeds

        counts = np.array([len(p) for p in partitions], dtype=np.int64)
        self.lane_start = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(counts, out=self.lane_start[1:])
        self.lane_end = self.lane_start[1:]
        self.nflat = int(self.lane_start[-1])
        self.reqs: list[Request] = [r for p in partitions for r in p]
        n = self.nflat
        self.arr_s = np.array([r.arrival_s for r in self.reqs], dtype=np.float64) \
            if n else np.zeros(0, dtype=np.float64)
        self.plen = np.array([r.prompt_len for r in self.reqs], dtype=np.int64) \
            if n else np.zeros(0, dtype=np.int64)
        self.olen = np.array([r.output_len for r in self.reqs], dtype=np.int64) \
            if n else np.zeros(0, dtype=np.int64)
        self.prio = np.array([class_priority(r.slo_class) for r in self.reqs],
                             dtype=np.int64) if n else np.zeros(0, dtype=np.int64)
        for r in range(R):
            s, e = self.lane_start[r], self.lane_end[r]
            if e - s > 1 and (np.diff(self.arr_s[s:e]) < 0).any():
                raise ValueError("arrivals must be non-decreasing per lane")

        # per-request outputs (phase is implicit: queued = index >= i_pref,
        # active = present in a lane's slot set, finished = finish not NaN)
        self.ttft = np.full(n, np.nan)
        self.first = np.full(n, np.nan)
        self.last = np.full(n, np.nan)
        self.finish = np.full(n, np.nan)
        self.tok = np.zeros(n, dtype=np.int64)

        # per-lane clocks and pointers
        self.t = np.full(R, start_s)          # single-pool clock / dpd pool A
        self.t_b = np.full(R, start_s)        # dpd pool B clock
        self.link_free = np.full(R, start_s)  # dpd FIFO link chain
        self.i_pref = self.lane_start[:-1].copy()   # next request to prefill
        self.done = np.zeros(R, dtype=bool)
        self.link_bytes = np.zeros(R)
        self.link_busy = np.zeros(R)

        # admission caps (ReplicaSim.cap, derived per lane from its own
        # partition exactly as the lazy property does). The continuous
        # policy admits through the block ledger instead; its slot arrays
        # only need to hold the running set, bounded by max_batch.
        if self.policy.kind == "continuous":
            self.cap = np.full(R, mode.max_batch, dtype=np.int64)
        else:
            self.cap = self._compute_caps(partitions, ctx_estimate)
        C = int(self.cap.max()) if R else 1
        self.C = C
        # active decode sets: [R, C] slot arrays, slots >= act_n zeroed
        self.act_f = np.zeros((R, C), dtype=np.int64)
        self.act_ctx = np.zeros((R, C), dtype=np.int64)
        self.act_rem = np.zeros((R, C), dtype=np.int64)
        self.act_n = np.zeros(R, dtype=np.int64)
        self._slots = np.arange(C, dtype=np.int64)

        # dpd ready stream: at most one entry per request with output_len>1,
        # laid out per lane like the request arrays (serialized only - the
        # continuous policy admits through per-lane DpdReadyQueue objects)
        if mode.kind == "dpd" and self.policy.kind == "serialized":
            rcounts = np.zeros(R, dtype=np.int64)
            for r in range(R):
                s, e = self.lane_start[r], self.lane_end[r]
                rcounts[r] = int((self.olen[s:e] > 1).sum())
            self.r_start = np.zeros(R + 1, dtype=np.int64)
            np.cumsum(rcounts, out=self.r_start[1:])
            m = int(self.r_start[-1])
            self.ready_t = np.zeros(m)
            self.ready_f = np.zeros(m, dtype=np.int64)
            self.r_wp = self.r_start[:-1].copy()   # write pointer (pool A)
            self.r_rp = self.r_start[:-1].copy()   # read pointer (pool B)

        # chip accumulators + optional segment log (columns appended per
        # charge batch; per-lane order == charge order == ReplicaSim order)
        self.busy = np.zeros((R, len(names)))
        self.energy = np.zeros((R, len(names)))
        self._segs = [([], [], [], []) for _ in names] if record_segments else None

        # cost memos (scalar-function results keyed on integer inputs)
        self._pref_cache: dict = {}
        self._dec_cache: dict = {}

        self._rngs = None
        self._fleet_rng = None
        if mode.kind in ("spec", "dsd"):
            if rng_mode == "sequential":
                self._rngs = [np.random.default_rng(s) for s in seeds]
            else:
                self._fleet_rng = np.random.default_rng(list(seeds) or 0)

        # per-iteration callback for the continuous lockstep loops (the
        # ledger-conservation property test samples populations here)
        self.iter_hook = None
        if self.policy.kind == "continuous":
            self._init_continuous()

    def _init_continuous(self) -> None:
        """Arena + knobs of the lockstep continuous executor.

        Ledger sizing, decode_tokens, and mix_decode come from the SAME
        batching.py builders the scalar executor constructs its scheduler
        with, so the two cannot drift; the builder's scheduler object is
        only read for those knobs and then dropped."""
        mode, pol, R = self.mode, self.policy, self.R
        n = self.nflat
        self._ci_of = {nm: i for i, nm in enumerate(self.chip_names)}
        # arena: per-request scheduler scalars (flat index == submission
        # `order` within a lane, so index ties reproduce SchedSeq.order)
        self.tgt = self.plen.copy()                       # prefill_target
        self.pfd = np.zeros(n, dtype=np.int64)            # prefilled
        self.emt = np.zeros(n, dtype=np.int64)            # emitted
        self.kvt = np.zeros(n, dtype=np.int64)            # kv tokens
        self.held = np.zeros(n, dtype=np.int64)           # blocks held
        self.enq = np.zeros(n, dtype=np.int64)            # enqueue_step
        self.waitq: list[list[int]] = [[] for _ in range(R)]
        self.prefq: list[list[int]] = [[] for _ in range(R)]
        # [R] queue-length mirrors, resynced at every mutation site - the
        # lockstep loop reads these instead of len()-scanning R lists
        self.n_wait = np.zeros(R, dtype=np.int64)
        self.n_pref = np.zeros(R, dtype=np.int64)
        self.step = np.zeros(R, dtype=np.int64)           # next_plan count
        self.used = np.zeros(R, dtype=np.int64)           # owned blocks
        self._cdec_cache: dict = {}
        if mode.kind == "dpd":
            tmpl = build_dpd_prefill_scheduler(
                pol, mode.max_batch, self.target_cfg, self.new_chip)
            self._kb = _Knobs(tmpl.ledger.num_blocks,
                              tmpl.policy.chunk_tokens, pol.token_budget,
                              pol.block_size, pol.age_steps, mode.max_batch,
                              1, True, pol.tpot_guard_frac)
            self._nb_b = build_dpd_decode_ledger(
                pol, self.target_cfg, self.old_chip).num_blocks
            self.readyq = [DpdReadyQueue(pol.age_steps) for _ in range(R)]
            self.n_ready = np.zeros(R, dtype=np.int64)
            self.runq_a: list[list[int]] = [[] for _ in range(R)]
            self.used_b = np.zeros(R, dtype=np.int64)     # pool B owned
            self._pricer = shared_pricer(
                "dpd", self.target_cfg, None, self.new_chip, self.old_chip,
                interconnect=mode.interconnect)
        else:
            tmpl = build_single_pool_scheduler(
                pol, mode.kind, mode.max_batch, mode.spec_k,
                self.target_cfg, self.draft_cfg, self.new_chip)
            self._kb = _Knobs(tmpl.ledger.num_blocks, pol.chunk_tokens,
                              pol.token_budget, pol.block_size,
                              pol.age_steps, mode.max_batch,
                              tmpl.decode_tokens, tmpl.mix_decode,
                              pol.tpot_guard_frac)
            self._pricer = shared_pricer(
                mode.kind, self.target_cfg, self.draft_cfg, self.new_chip,
                self.old_chip, k=mode.spec_k,
                interconnect=mode.interconnect, overlap=mode.overlap_comm)

    # ------------------------------------------------------------ setup
    def _compute_caps(self, partitions, ctx_estimate) -> np.ndarray:
        mode = self.mode
        decode_chip = self.old_chip if mode.kind == "dpd" else self.new_chip
        memo: dict[int, int] = {}

        def cap_for(ctx: int) -> int:
            c = memo.get(ctx)
            if c is None:
                c = min(mode.max_batch,
                        max_concurrency(self.target_cfg, decode_chip, ctx))
                if self.draft_cfg is not None and mode.kind == "spec":
                    c = min(c, max_concurrency(self.draft_cfg, self.new_chip, ctx))
                memo[ctx] = max(c, 1)
            return memo[ctx]

        caps = np.empty(self.R, dtype=np.int64)
        for r in range(self.R):
            if ctx_estimate is not None:
                ctx = ctx_estimate
            else:
                s, e = self.lane_start[r], self.lane_end[r]
                ctx = int(np.mean(self.plen[s:e] + self.olen[s:e])) \
                    if e > s else 512
            caps[r] = cap_for(int(ctx))
        return caps

    # ------------------------------------------------------------ charging
    def _charge(self, ci: int, lanes: np.ndarray, t0: np.ndarray,
                dt: np.ndarray, de: np.ndarray) -> None:
        """One charge batch on chip column `ci` (ChipUse.add, vectorized)."""
        self.busy[lanes, ci] += dt
        self.energy[lanes, ci] += de
        if self._segs is not None:
            sl, s0, s1, se = self._segs[ci]
            sl.append(lanes.copy())
            s0.append(np.array(t0))
            s1.append(t0 + dt)
            se.append(np.array(de))

    def _charge1(self, ci: int, r: int, t0: float, dt: float,
                 de: float) -> None:
        """Scalar `_charge` for single-lane steps (no array wrapping on
        the busy/energy accumulate; segments still log ndarray rows)."""
        self.busy[r, ci] += dt
        self.energy[r, ci] += de
        if self._segs is not None:
            sl, s0, s1, se = self._segs[ci]
            sl.append(np.array([r]))
            s0.append(np.array([t0]))
            s1.append(np.array([t0 + dt]))
            se.append(np.array([de]))

    # ------------------------------------------------------------ cost memos
    def _pref_compute(self, pl: int):
        m = self.mode
        sched = prefill_charges(m.kind, self.target_cfg, self.draft_cfg,
                                self.new_chip, self.old_chip, int(pl))
        ch = sched.charges
        if m.kind in ("standalone", "dpd"):
            c = ch[0][1]
            row = [c.time_s, c.energy_j, sched.duration_s]
            if m.kind == "dpd":
                nbytes = dpd_kv_bytes(self.target_cfg, int(pl))
                row += [nbytes, m.interconnect.transfer_time(nbytes)]
            return row
        # spec: target then draft serialized; dsd: target/new + draft/old parallel
        c_t, c_d = ch[0][1], ch[1][1]
        return [c_t.time_s, c_t.energy_j, c_d.time_s, c_d.energy_j,
                sched.duration_s]

    def _dec_compute(self, key: int):
        b, ctx = int(key) >> _CTX_BITS, int(key) & _CTX_MASK
        m = self.mode
        if m.kind == "standalone":
            c = decode_cost(self.target_cfg, self.new_chip, b, ctx)
            return [c.time_s, c.energy_j]
        if m.kind == "dpd":
            c = decode_cost(self.target_cfg, self.old_chip, b, ctx)
            return [c.time_s, c.energy_j]
        _, c_d, c_t = spec_round_charges(
            m.kind, self.target_cfg, self.draft_cfg,
            self.new_chip, self.old_chip, b, ctx, m.spec_k)
        if m.kind == "spec":
            rt = spec_round_time("spec", c_d, c_t, m.interconnect, 0, 0)
            return [c_d.time_s, c_d.energy_j, c_t.time_s, c_t.energy_j, rt]
        ids_b, probs_b = dsd_link_bytes(self.draft_cfg, b, m.spec_k)
        rt = spec_round_time("dsd", c_d, c_t, m.interconnect, ids_b, probs_b,
                             overlap=m.overlap_comm)
        lbusy = (m.interconnect.transfer_time(ids_b)
                 + m.interconnect.transfer_time(probs_b))
        return [c_d.time_s, c_d.energy_j, c_t.time_s, c_t.energy_j, rt,
                ids_b + probs_b, lbusy]

    # ------------------------------------------------------------ driving
    def advance_to(self, t_stop: float) -> "VectorFleetSim":
        if self.policy.kind == "continuous":
            if self.mode.kind == "dpd":
                self._advance_dpd_continuous(t_stop)
            else:
                self._advance_continuous(t_stop)
        elif self.mode.kind == "dpd":
            self._advance_dpd(t_stop)
        else:
            self._advance_single(t_stop)
        for sim in self._chaos.values():
            sim.advance_to(t_stop)
        return self

    def drain(self) -> "VectorFleetSim":
        return self.advance_to(math.inf)

    # ----------------------------------------- standalone / spec / dsd
    def _advance_single(self, t_stop: float) -> None:
        while True:
            runnable = ~self.done & (self.t < t_stop)
            if not runnable.any():
                return
            has_next = self.i_pref < self.lane_end
            safe = np.minimum(self.i_pref, max(self.nflat - 1, 0))
            nxt_arr = np.where(has_next, self.arr_s[safe] if self.nflat
                               else np.inf, np.inf)
            has_pref = runnable & has_next & (nxt_arr <= self.t)
            has_act = self.act_n > 0
            idle = runnable & ~has_pref & ~has_act
            done_now = idle & ~has_next
            jump = idle & has_next & (nxt_arr < t_stop)
            pref = has_pref & (self.act_n < self.cap)
            dec = runnable & (has_pref | has_act) & ~pref
            if not (pref.any() or dec.any() or jump.any() or done_now.any()):
                return                      # everything left blocks on t_stop
            if done_now.any():
                self.done |= done_now
            if jump.any():
                self.t[jump] = np.maximum(self.t[jump], nxt_arr[jump])
            if pref.any():
                self._do_prefill(np.nonzero(pref)[0])
            if dec.any():
                self._do_decode(np.nonzero(dec)[0])

    def _do_prefill(self, lanes: np.ndarray) -> None:
        kind = self.mode.kind
        f = self.i_pref[lanes]
        vals = _gather(self.plen[f], self._pref_cache, self._pref_compute,
                       3 if kind == "standalone" else 5)
        t0 = self.t[lanes]
        if kind == "standalone":
            self._charge(0, lanes, t0, vals[:, 0], vals[:, 1])
            dur = vals[:, 2]
        elif kind == "spec":
            self._charge(0, lanes, t0, vals[:, 0], vals[:, 1])
            self._charge(0, lanes, t0 + vals[:, 0], vals[:, 2], vals[:, 3])
            dur = vals[:, 4]
        else:  # dsd: target on new, draft on old, parallel pools
            self._charge(0, lanes, t0, vals[:, 0], vals[:, 1])
            self._charge(self._old_ci, lanes, t0, vals[:, 2], vals[:, 3])
            dur = vals[:, 4]
        tnew = t0 + dur
        self.t[lanes] = tnew
        self._finish_prefill(lanes, f, tnew, self.plen[f] + 1)
        self.i_pref[lanes] += 1

    def _finish_prefill(self, lanes: np.ndarray, f: np.ndarray,
                        tnew: np.ndarray, ctx0: np.ndarray) -> None:
        """First-token bookkeeping + activation (ReplicaSim._step_prefill)."""
        self.ttft[f] = tnew - self.arr_s[f]
        self.first[f] = tnew
        self.last[f] = tnew
        self.tok[f] = 1
        multi = self.olen[f] > 1
        ml, mf = lanes[multi], f[multi]
        slot = self.act_n[ml]
        self.act_f[ml, slot] = mf
        self.act_ctx[ml, slot] = ctx0[multi]
        self.act_rem[ml, slot] = self.olen[mf] - 1
        self.act_n[ml] += 1
        self.finish[f[~multi]] = tnew[~multi]

    def _round_emitted(self, lanes: np.ndarray, sub_rem: np.ndarray,
                       m: np.ndarray) -> np.ndarray:
        """Tokens emitted per active slot for one decode round ([L, cmax])."""
        kind = self.mode.kind
        if kind in ("standalone", "dpd"):
            return m.astype(np.int64)
        acc, k = self.mode.acceptance, self.mode.spec_k
        e = np.zeros_like(sub_rem)
        if self.rng_mode == "sequential":
            for i, li in enumerate(lanes.tolist()):
                g = self._rngs[li]
                for j in range(int(self.act_n[li])):
                    e[i, j] = min(_emit_round_tokens(g, acc, k),
                                  int(sub_rem[i, j]))
        else:
            total = int(m.sum())
            u = self._fleet_rng.random((total, k))
            run = (u < acc).cumprod(axis=1).sum(axis=1) + 1
            e[m] = np.minimum(run, sub_rem[m])
        return e

    def _do_decode(self, lanes: np.ndarray) -> None:
        kind = self.mode.kind
        b = self.act_n[lanes]
        cmax = int(b.max())
        cols = self._slots[:cmax]
        # fancy row index + basic column slice: one advanced-indexing pass,
        # measurably cheaper than broadcasting [L,1]x[1,cmax] index arrays
        sub_f = self.act_f[lanes, :cmax]
        sub_ctx = self.act_ctx[lanes, :cmax]
        sub_rem = self.act_rem[lanes, :cmax]
        ctx = (sub_ctx.sum(axis=1).astype(np.float64)
               / b).astype(np.int64)          # == int(np.mean([a.ctx ...]))
        keys = (b << _CTX_BITS) | ctx
        width = {"standalone": 2, "dpd": 2, "spec": 5, "dsd": 7}[kind]
        vals = _gather(keys, self._dec_cache, self._dec_compute, width)
        t0 = self.t[lanes] if kind != "dpd" else self.t_b[lanes]
        if kind in ("standalone", "dpd"):
            ci = 0 if kind == "standalone" else self._old_ci
            self._charge(ci, lanes, t0, vals[:, 0], vals[:, 1])
            tnew = t0 + vals[:, 0]
        else:
            draft_ci = 0 if kind == "spec" else self._old_ci
            self._charge(draft_ci, lanes, t0, vals[:, 0], vals[:, 1])
            self._charge(0, lanes, t0 + vals[:, 0], vals[:, 2], vals[:, 3])
            if kind == "dsd":
                self.link_bytes[lanes] += vals[:, 5]
                self.link_busy[lanes] += vals[:, 6]
            tnew = t0 + vals[:, 4]
        if kind == "dpd":
            self.t_b[lanes] = tnew
        else:
            self.t[lanes] = tnew

        m = cols[None, :] < b[:, None]
        e = self._round_emitted(lanes, sub_rem, m)
        rows = sub_f[m]
        self.tok[rows] += e[m]
        tmat = np.broadcast_to(tnew[:, None], m.shape)
        self.last[rows] = tmat[m]
        sub_ctx += e
        sub_rem -= e
        fin = m & (sub_rem <= 0)
        nfin = fin.sum(axis=1)
        if nfin.any():
            self.finish[sub_f[fin]] = tmat[fin]
            # stable left-compaction of the surviving slots (list.remove
            # order), restricted to the lanes that retired something
            sel = nfin > 0
            keep = m[sel] & ~fin[sel]
            pos = np.cumsum(keep, axis=1) - 1
            r_i, c_i = np.nonzero(keep)
            srows = lanes[sel]
            for arr, valsrc in ((self.act_f, sub_f[sel]),
                                (self.act_ctx, sub_ctx[sel]),
                                (self.act_rem, sub_rem[sel])):
                newsub = np.zeros_like(valsrc)
                newsub[r_i, pos[r_i, c_i]] = valsrc[r_i, c_i]
                arr[srows, :cmax] = newsub
            self.act_n[srows] = keep.sum(axis=1)
            ok = ~sel
            if ok.any():
                orows = lanes[ok]
                self.act_ctx[orows, :cmax] = sub_ctx[ok]
                self.act_rem[orows, :cmax] = sub_rem[ok]
        else:
            self.act_ctx[lanes, :cmax] = sub_ctx
            self.act_rem[lanes, :cmax] = sub_rem

    # ------------------------------------------------------------ dpd
    def _advance_dpd(self, t_stop: float) -> None:
        # pool A: one prefill per lane per iteration, pipelined FIFO link
        while True:
            live = self.i_pref < self.lane_end
            if not live.any():
                break
            f = np.minimum(self.i_pref, max(self.nflat - 1, 0))
            start = np.maximum(self.t, self.arr_s[f])
            lanes = np.nonzero(live & (start < t_stop))[0]
            if not len(lanes):
                break
            f = self.i_pref[lanes]
            self.t[lanes] = start[lanes]
            vals = _gather(self.plen[f], self._pref_cache,
                           self._pref_compute, 5)
            t0 = self.t[lanes]
            self._charge(0, lanes, t0, vals[:, 0], vals[:, 1])
            tnew = t0 + vals[:, 2]
            self.t[lanes] = tnew
            self.ttft[f] = tnew - self.arr_s[f]
            self.first[f] = tnew
            self.last[f] = tnew
            self.tok[f] = 1
            nbytes, tx = vals[:, 3], vals[:, 4]
            lstart = np.maximum(tnew, self.link_free[lanes])
            lfree = lstart + tx
            self.link_free[lanes] = lfree
            self.link_bytes[lanes] += nbytes
            self.link_busy[lanes] += tx
            multi = self.olen[f] > 1
            ml = lanes[multi]
            wp = self.r_wp[ml]
            self.ready_t[wp] = lfree[multi]
            self.ready_f[wp] = f[multi]
            self.r_wp[ml] += 1
            self.finish[f[~multi]] = tnew[~multi]
            self.i_pref[lanes] += 1

        # pool B: admission from the ready stream + decode rounds
        while True:
            has_ready = self.r_rp < self.r_wp
            live = (has_ready | (self.act_n > 0)) & (self.t_b < t_stop)
            if not live.any():
                return
            # admission: one ready entry per lane per sub-iteration
            while True:
                safe = np.minimum(self.r_rp, max(len(self.ready_t) - 1, 0))
                rt = self.ready_t[safe] if len(self.ready_t) else \
                    np.zeros(self.R)
                can = live & (self.r_rp < self.r_wp) & (rt <= self.t_b) \
                    & (self.act_n < self.cap)
                if not can.any():
                    break
                ml = np.nonzero(can)[0]
                mf = self.ready_f[self.r_rp[ml]]
                slot = self.act_n[ml]
                self.act_f[ml, slot] = mf
                self.act_ctx[ml, slot] = self.plen[mf] + 1
                self.act_rem[ml, slot] = self.olen[mf] - 1
                self.act_n[ml] += 1
                self.r_rp[ml] += 1
            has_ready = self.r_rp < self.r_wp
            idle = live & (self.act_n == 0)
            # idle lanes with a pending ready entry jump to it (the serial
            # loop assigns t_b = nxt; nxt > t_b holds or it would have been
            # admitted above); idle lanes without one wait on pool A
            jump = idle & has_ready
            if jump.any():
                safe = np.minimum(self.r_rp, len(self.ready_t) - 1)
                nxt = self.ready_t[safe]
                jmp = jump & (nxt < t_stop)
                self.t_b[jmp] = nxt[jmp]
            dec = live & (self.act_n > 0)
            if dec.any():
                self._do_decode(np.nonzero(dec)[0])
            elif not jump.any():
                return                       # all blocked on horizon / pool A

    # ------------------------------------------- continuous policy (lockstep)
    def _submit_due(self, sub: np.ndarray) -> None:
        """Move due arrivals into the waiting queues, stamping the lane's
        CURRENT step counter (ReplicaSim submits before next_plan's
        increment, so enqueue_step is the pre-increment value)."""
        for r in np.nonzero(sub)[0].tolist():
            i, e = int(self.i_pref[r]), int(self.lane_end[r])
            now, st, w = float(self.t[r]), int(self.step[r]), self.waitq[r]
            while i < e and self.arr_s[i] <= now:
                self.enq[i] = st
                w.append(i)
                i += 1
            self.i_pref[r] = i
            self.n_wait[r] = len(w)

    def _next_arrivals(self):
        has_next = self.i_pref < self.lane_end
        safe = np.minimum(self.i_pref, max(self.nflat - 1, 0))
        nxt = np.where(has_next, self.arr_s[safe] if self.nflat else np.inf,
                       np.inf)
        return has_next, nxt

    def _plan_lane(self, wait: list, pref: list, run: list, kb: _Knobs,
                   step_now: int, used0: int):
        """Faithful per-lane port of `ContinuousScheduler.next_plan` over
        the arena arrays (one integer per scalar `SchedSeq` carries; the
        flat index doubles as `order`/`sid`). Built from the same
        batching.py plan-arithmetic helpers as the scalar scheduler, so
        every admission / preemption / slate decision is the same integer
        expression. Returns (chunks, decodes, used): chunks are
        (f, take, ctx_before, completes) tuples in plan order; `used` is
        the lane's owned-block count after planning-side mutations."""
        tgt, pfd, emt, kvt, held, enq = (self.tgt, self.pfd, self.emt,
                                         self.kvt, self.held, self.enq)
        prio, plen, olen = self.prio, self.plen, self.olen
        bs = kb.block_size
        st = {"used": used0}

        def free():
            return kb.num_blocks - st["used"]

        def wkey(f):
            return (aged_priority(int(prio[f]), step_now - int(enq[f]),
                                  kb.age_steps), f)

        dt_ = kb.decode_tokens

        def reserve(decs):
            # inlined growth_blocks sum (hot: twice per planned step)
            return sum(-(-(int(kvt[f]) + dt_) // bs) - int(held[f])
                       for f in decs)

        def preempt(f):
            st["used"] -= int(held[f])           # ledger.free
            held[f] = 0
            if f in run:
                run.remove(f)
            else:
                pref.remove(f)
            tgt[f] = recompute_target(int(plen[f]), int(emt[f]))
            pfd[f] = 0
            kvt[f] = 0
            enq[f] = step_now                    # aging credit resets
            wait.append(f)

        def select_decodes():
            slots = decode_slot_count(kb.token_budget, kb.decode_tokens)
            if len(run) <= slots:
                return list(run)
            chosen = set(sorted(
                run, key=lambda f: (prio[f], olen[f] - emt[f], f))[:slots])
            return [f for f in run if f in chosen]

        def pick_victim(decs, max_priority=None):
            in_d = set(decs)
            cands = [(f, 0) for f in pref]
            cands += [(f, 1) for f in run if f not in in_d]
            if len(decs) > 1:
                cands += [(f, 2) for f in decs]
            elif decs and (any(prio[p] < prio[decs[0]] for p in pref)
                           or (max_priority is not None
                               and prio[decs[0]] > max_priority)):
                cands += [(f, 2) for f in decs]
            if max_priority is not None:
                cands = [(f, c) for f, c in cands if prio[f] > max_priority]
            if not cands:
                return None
            return max(cands, key=lambda c: (prio[c[0]], -c[1], c[0]))[0]

        def queue_head():
            for f in pref:
                if pfd[f] < tgt[f]:
                    return f
            if wait:
                wait.sort(key=wkey)
                return wait[0]
            return None

        def build_chunks(budget, rsv, skip=frozenset(), decs=()):
            chunks = []
            guard_cap = None
            worst = -1
            if decs and kb.tpot_guard_frac < 1.0:
                worst = max(int(prio[f]) for f in decs)
                guard_cap = guard_cap_tokens(kb.tpot_guard_frac,
                                             kb.token_budget)
            guarded_used = 0

            def guard_room(f):
                if guard_cap is None or prio[f] >= worst:
                    return kb.token_budget
                return guard_cap - guarded_used

            for f in pref:
                if budget <= 0:
                    break
                take = chunk_take(kb.chunk_tokens, int(tgt[f]), int(pfd[f]),
                                  budget, guard_room(f))
                if take <= 0:
                    continue
                need = blocks_for(int(pfd[f]) + take, bs) - int(held[f])
                if need > free() - rsv:
                    break                        # head-of-line, no skipping
                if need > 0:                     # ledger.extend_to
                    held[f] += need
                    st["used"] += need
                chunks.append((f, take, int(pfd[f]),
                               int(pfd[f]) + take >= int(tgt[f])))
                budget -= take
                if guard_cap is not None and prio[f] < worst:
                    guarded_used += take
            wait.sort(key=wkey)
            while (budget > 0 and wait
                   and len(pref) + len(run) < kb.max_batch):
                f = wait[0]
                if f in skip:
                    break                        # this-step victim blocks
                if guard_room(f) <= 0:
                    break                        # guard-capped head stalls
                take = chunk_take(kb.chunk_tokens, int(tgt[f]), 0, budget,
                                  guard_room(f))
                need = blocks_for(take, bs)
                if need > free() - rsv:
                    break                        # priority order holds
                wait.pop(0)
                held[f] = need                   # ledger.allocate
                st["used"] += need
                pref.append(f)
                chunks.append((f, take, int(pfd[f]),
                               int(pfd[f]) + take >= int(tgt[f])))
                budget -= take
                if guard_cap is not None and prio[f] < worst:
                    guarded_used += take
            return chunks

        def admission_preempt(decs, preempted, budget_of):
            chunks = []
            while not chunks:
                head = queue_head()
                if head is None:
                    return chunks
                budget = budget_of(decs)
                if budget <= 0:
                    return chunks
                take = chunk_take(kb.chunk_tokens, int(tgt[head]),
                                  int(pfd[head]), budget, kb.token_budget)
                need = blocks_for(int(pfd[head]) + take, bs) \
                    - int(held[head])
                reclaimable = sum(int(held[f]) for f in pref + run
                                  if prio[f] > prio[head])
                reserve_keep = reserve(
                    [f for f in decs if prio[f] <= prio[head]])
                if need > free() + reclaimable - reserve_keep:
                    return chunks                # futile: would churn
                victim = pick_victim(decs, max_priority=int(prio[head]))
                if victim is None:
                    return chunks
                preempt(victim)
                if victim in decs:
                    decs.remove(victim)
                preempted.append(victim)
                chunks = build_chunks(budget_of(decs), reserve(decs),
                                      skip=set(preempted), decs=decs)
            return chunks

        preempted = []
        if not kb.mix_decode:
            chunks = build_chunks(kb.token_budget, reserve(run))
            if not chunks:
                chunks = admission_preempt(run, preempted,
                                           lambda _d: kb.token_budget)
            if chunks:
                return chunks, [], st["used"]
        decs = select_decodes()
        rsv = reserve(decs)
        while rsv > free():
            victim = pick_victim(decs)
            if victim is None:
                break
            preempt(victim)
            if victim in decs:
                decs.remove(victim)
            preempted.append(victim)
            rsv = reserve(decs)
        if rsv > free():
            raise OutOfBlocks(
                f"KV pool of {kb.num_blocks} blocks cannot grow a "
                f"single sequence (kv={int(kvt[decs[0]])} "
                f"+{kb.decode_tokens} tokens)")
        chunks = [] if not kb.mix_decode else build_chunks(
            kb.token_budget - len(decs), rsv,
            skip=set(preempted), decs=decs)
        if kb.mix_decode and not chunks and decs:
            chunks = admission_preempt(
                decs, preempted, lambda d: kb.token_budget - len(d))
        if not chunks and not decs:
            while not chunks and len(pref) > 1:
                victim = max(pref, key=lambda f: (prio[f], f))
                preempt(victim)
                preempted.append(victim)
                chunks = build_chunks(kb.token_budget, 0,
                                      skip=set(preempted))
            if not chunks:
                if pref or wait:
                    raise OutOfBlocks(
                        f"KV pool of {kb.num_blocks} blocks cannot fit "
                        f"the next prefill chunk of any queued sequence")
                return [], [], st["used"]
        return chunks, decs, st["used"]

    def _cdec_compute(self, key: int):
        """Decode-only HybridSchedule row for one (n_dec, sum ctx) key,
        through the shared pricer (the SAME memo entries the scalar
        continuous executor reads and writes)."""
        n = int(key) >> _A2_BITS
        a2 = int(key) & _A2_MASK
        hs = self._pricer.charges_for_key((0, 0, 0, n, a2))
        kind = self.mode.kind
        c0 = hs.charges[0][1]
        if kind in ("standalone", "dpd"):
            return [c0.time_s, c0.energy_j]
        ct, rel = hs.charges[1][1], hs.charges[1][2]
        row = [c0.time_s, c0.energy_j, ct.time_s, ct.energy_j, rel,
               hs.duration_s]
        if kind == "dsd":
            ic = self.mode.interconnect
            row += [hs.link_ids_bytes + hs.link_probs_bytes,
                    ic.transfer_time(hs.link_ids_bytes)
                    + ic.transfer_time(hs.link_probs_bytes)]
        return row

    def _compact_slots(self, lanes: np.ndarray, sub_f: np.ndarray,
                       m: np.ndarray, fin: np.ndarray, nmax: int) -> None:
        """Stable left-compaction of surviving run slots (list.remove
        order), restricted to the lanes that retired something."""
        sel = fin.sum(axis=1) > 0
        if not sel.any():
            return
        keep = m[sel] & ~fin[sel]
        pos = np.cumsum(keep, axis=1) - 1
        r_i, c_i = np.nonzero(keep)
        srows = lanes[sel]
        newsub = np.zeros_like(sub_f[sel])
        newsub[r_i, pos[r_i, c_i]] = sub_f[sel][r_i, c_i]
        self.act_f[srows, :nmax] = newsub
        self.act_n[srows] = keep.sum(axis=1)

    def _fast_decode_book(self, lanes: np.ndarray, sub_f: np.ndarray,
                          m: np.ndarray, e: np.ndarray, tnew: np.ndarray,
                          block_size: int, used_arr: np.ndarray,
                          nmax: int) -> None:
        """Post-step bookkeeping of a vectorized pure-decode round:
        emissions, KV growth (ledger extend), finishes (ledger free),
        slot compaction - the array form of note_decode/_finish."""
        rows = sub_f[m]
        ev = e[m]
        # m is a prefix mask (slots < act_n), so boolean gathers list each
        # lane's slots contiguously: per-lane aggregates are reduceat
        # segments and lane-time stamps are repeats - no [L, nmax]
        # scratch matrices on the no-finish common case
        counts = m.sum(axis=1)
        off = np.cumsum(counts) - counts
        self.tok[rows] += ev
        self.last[rows] = np.repeat(tnew, counts)
        emt_new = self.emt[rows] + ev
        kv_new = self.kvt[rows] + ev
        self.emt[rows] = emt_new
        self.kvt[rows] = kv_new
        nh = -(-kv_new // block_size)            # blocks_for, vectorized
        grown = nh - self.held[rows]
        self.held[rows] = nh
        delta = np.add.reduceat(grown, off)
        done = (self.olen[rows] - emt_new) <= 0
        if done.any():
            frows = rows[done]
            nfin = np.add.reduceat(done.astype(np.int64), off)
            self.finish[frows] = np.repeat(tnew, nfin)
            delta -= np.add.reduceat(np.where(done, nh, 0), off)
            self.held[frows] = 0
        used_arr[lanes] += delta
        if done.any():
            fin = np.zeros(m.shape, dtype=bool)
            fin[m] = done
            self._compact_slots(lanes, sub_f, m, fin, nmax)

    def _fast_decode_cont(self, lanes: np.ndarray) -> None:
        """One vectorized pure-decode step for steady single-pool lanes.

        Eligibility (checked by the caller): empty waiting/prefilling
        queues, 0 < running <= decode slots, growth reserve within the
        free pool. Under those conditions `next_plan` provably returns
        StepPlan([], running, []) with no planning side effects for both
        mix_decode settings, so the step prices straight off the
        (n_dec, sum ctx) aggregate key."""
        kind = self.mode.kind
        kb = self._kb
        nmax = int(self.act_n[lanes].max())
        sub_f = self.act_f[lanes, :nmax]
        m = self._slots[:nmax][None, :] < self.act_n[lanes][:, None]
        ctx = (self.plen[sub_f] + self.emt[sub_f]) * m
        keys = (self.act_n[lanes] << _A2_BITS) | ctx.sum(axis=1)
        width = {"standalone": 2, "spec": 6, "dsd": 8}[kind]
        vals = _gather(keys, self._cdec_cache, self._cdec_compute, width)
        t0 = self.t[lanes]
        if kind == "standalone":
            self._charge(0, lanes, t0, vals[:, 0], vals[:, 1])
            tnew = t0 + vals[:, 0]
        else:
            first_ci = 0 if kind == "spec" else self._old_ci
            self._charge(first_ci, lanes, t0, vals[:, 0], vals[:, 1])
            self._charge(0, lanes, t0 + vals[:, 4], vals[:, 2], vals[:, 3])
            if kind == "dsd":
                self.link_bytes[lanes] += vals[:, 6]
                self.link_busy[lanes] += vals[:, 7]
            tnew = t0 + vals[:, 5]
        self.t[lanes] = tnew
        if kind == "standalone":
            e = m.astype(np.int64)
        else:
            rem = self.olen[sub_f] - self.emt[sub_f]
            e = np.zeros_like(rem)
            acc, k = self.mode.acceptance, self.mode.spec_k
            if self.rng_mode == "sequential":
                for i, li in enumerate(lanes.tolist()):
                    g = self._rngs[li]
                    for j in range(int(self.act_n[li])):
                        e[i, j] = min(_emit_round_tokens(g, acc, k),
                                      int(rem[i, j]))
            else:
                total = int(m.sum())
                u = self._fleet_rng.random((total, k))
                runl = (u < acc).cumprod(axis=1).sum(axis=1) + 1
                e[m] = np.minimum(runl, rem[m])
        self._fast_decode_book(lanes, sub_f, m, e, tnew, kb.block_size,
                               self.used, nmax)

    def _slow_step_single(self, r: int) -> None:
        """One full scheduler step for a lane the fast path cannot take
        (pending admissions, slate pressure, or growth preemption):
        per-lane plan, shared-pricer charge, scalar-order bookkeeping."""
        kb = self._kb
        mode = self.mode
        run = self.act_f[r, :int(self.act_n[r])].tolist()
        chunks, decs, used = self._plan_lane(
            self.waitq[r], self.prefq[r], run, kb,
            int(self.step[r]), int(self.used[r]))
        plen, olen, emt = self.plen, self.olen, self.emt
        kvt, held, tok = self.kvt, self.held, self.tok
        bs = kb.block_size
        cspecs = tuple((int(tk), int(c0)) for _f, tk, c0, _cm in chunks)
        dctxs = tuple(int(plen[f]) + int(emt[f]) for f in decs)
        hs = self._pricer.charges_for_key(hybrid_step_key(cspecs, dctxs))
        t0 = float(self.t[r])
        for name, cost, rel in hs.charges:
            self._charge1(self._ci_of[name], r, t0 + rel,
                          cost.time_s, cost.energy_j)
        if hs.link_ids_bytes or hs.link_probs_bytes:
            ic = mode.interconnect
            self.link_bytes[r] += hs.link_ids_bytes + hs.link_probs_bytes
            self.link_busy[r] += (ic.transfer_time(hs.link_ids_bytes)
                                  + ic.transfer_time(hs.link_probs_bytes))
        tnew = t0 + hs.duration_s
        self.t[r] = tnew
        for f, take, _c0, _cm in chunks:         # complete_chunk, plan order
            self.pfd[f] += take
            kvt[f] = self.pfd[f]
            if self.pfd[f] < self.tgt[f]:
                continue
            self.prefq[r].remove(f)
            run.append(f)
            if emt[f] == 0:                      # fresh completion: TTFT
                self.ttft[f] = tnew - self.arr_s[f]
                self.first[f] = tnew
                self.last[f] = tnew
                tok[f] = 1
                emt[f] = 1
                if olen[f] <= 1:                 # note_first_token finish
                    self.finish[f] = tnew
                    used -= int(held[f])
                    held[f] = 0
                    run.remove(f)
        acc, k = mode.acceptance, mode.spec_k
        standalone = mode.kind == "standalone"
        for f in decs:                           # note_decode, plan order
            if standalone:
                e = 1
            else:
                rem = int(olen[f] - emt[f])
                if self._rngs is not None:
                    e = min(_emit_round_tokens(self._rngs[r], acc, k), rem)
                else:
                    u = self._fleet_rng.random(k)
                    e = min(int((u < acc).cumprod().sum()) + 1, rem)
            tok[f] += e
            self.last[f] = tnew
            emt[f] += e
            kvt[f] += e
            need = -(-int(kvt[f]) // bs) - int(held[f])   # blocks_for
            if need > 0:
                if need > kb.num_blocks - used:
                    raise OutOfBlocks(f"extend needs {need} blocks, "
                                      f"{kb.num_blocks - used} free")
                held[f] += need
                used += need
            if olen[f] - emt[f] <= 0:
                self.finish[f] = tnew
                used -= int(held[f])
                held[f] = 0
                run.remove(f)
        self.used[r] = used
        n = len(run)
        self.act_f[r, :n] = run
        self.act_n[r] = n
        self.n_wait[r] = len(self.waitq[r])
        self.n_pref[r] = len(self.prefq[r])

    def _advance_continuous(self, t_stop: float) -> None:
        """Lockstep continuous loop (standalone/spec/dsd): one scheduler
        step per working lane per iteration; steady pure-decode lanes step
        as one vectorized batch, the rest replay the scalar planner."""
        kb = self._kb
        R = self.R
        slots = decode_slot_count(kb.token_budget, kb.decode_tokens)
        while True:
            runnable = ~self.done & (self.t < t_stop)
            if not runnable.any():
                return
            has_next, nxt_arr = self._next_arrivals()
            sub = runnable & has_next & (nxt_arr <= self.t)
            if sub.any():
                self._submit_due(sub)
                has_next, nxt_arr = self._next_arrivals()
            n_wait, n_pref = self.n_wait, self.n_pref
            work = runnable & ((n_wait > 0) | (n_pref > 0)
                               | (self.act_n > 0))
            idle = runnable & ~work
            done_now = idle & ~has_next
            jump = idle & has_next & (nxt_arr < t_stop)
            if not (work.any() or jump.any() or done_now.any()):
                return                  # everything left blocks on t_stop
            if done_now.any():
                self.done |= done_now
            if jump.any():
                self.t[jump] = np.maximum(self.t[jump], nxt_arr[jump])
            if work.any():
                self.step[work] += 1             # next_plan's increment
                fast = np.zeros(R, dtype=bool)
                cand = work & (n_wait == 0) & (n_pref == 0) \
                    & (self.act_n > 0) & (self.act_n <= slots)
                if cand.any():
                    cl = np.nonzero(cand)[0]
                    nmax = int(self.act_n[cl].max())
                    sub_f = self.act_f[cl, :nmax]
                    m = self._slots[:nmax][None, :] \
                        < self.act_n[cl][:, None]
                    growth = (-(-(self.kvt[sub_f] + kb.decode_tokens)
                                // kb.block_size)
                              - self.held[sub_f]) * m
                    ok = growth.sum(axis=1) <= kb.num_blocks - self.used[cl]
                    fast[cl[ok]] = True
                if fast.any():
                    self._fast_decode_cont(np.nonzero(fast)[0])
                slow = work & ~fast
                for r in np.nonzero(slow)[0].tolist():
                    self._slow_step_single(r)
            if self.iter_hook is not None:
                self.iter_hook(self)

    # ------------------------------------------------- continuous dpd
    def _step_pool_a(self, r: int) -> None:
        """One pool-A step: batched chunked prefill on the new chip;
        completed prompts take their first token, ship KV over the FIFO
        link, and enter the lane's DpdReadyQueue (olen-1 seqs finish)."""
        chunks, _decs, used = self._plan_lane(
            self.waitq[r], self.prefq[r], self.runq_a[r], self._kb,
            int(self.step[r]), int(self.used[r]))
        if not chunks:                 # unreachable: has_work => chunks/raise
            self.used[r] = used
            return
        cspecs = tuple((int(tk), int(c0)) for _f, tk, c0, _cm in chunks)
        hs = self._pricer.charges_for_key(hybrid_step_key(cspecs, ()))
        cost = hs.charges[0][1]
        t0 = float(self.t[r])
        self._charge1(0, r, t0, cost.time_s, cost.energy_j)
        tnew = t0 + cost.time_s
        self.t[r] = tnew
        ic = self.mode.interconnect
        for f, take, _c0, _cm in chunks:
            self.pfd[f] += take
            self.kvt[f] = self.pfd[f]
            if self.pfd[f] < self.tgt[f]:
                continue
            # prefill complete: first token + retire (pool-A seqs model
            # output_len=1, so note_first_token finishes them here)
            self.prefq[r].remove(f)
            self.ttft[f] = tnew - self.arr_s[f]
            self.first[f] = tnew
            self.last[f] = tnew
            self.tok[f] = 1
            self.emt[f] = 1
            used -= int(self.held[f])            # pool-A ledger.free
            self.held[f] = 0
            nbytes = dpd_kv_bytes(self.target_cfg, int(self.plen[f]))
            tx = ic.transfer_time(nbytes)
            lstart = max(tnew, float(self.link_free[r]))
            self.link_free[r] = lstart + tx
            self.link_bytes[r] += nbytes
            self.link_busy[r] += tx
            if self.olen[f] > 1:
                self.readyq[r].push(float(self.link_free[r]),
                                    int(self.prio[f]), (f, 1))
                self.n_ready[r] += 1
            else:
                self.finish[f] = tnew
        self.used[r] = used
        self.n_wait[r] = len(self.waitq[r])
        self.n_pref[r] = len(self.prefq[r])

    def _fast_decode_b(self, lanes: np.ndarray) -> None:
        """Vectorized pool-B round for lanes where every active sequence
        is granted (total boundary-crossing need fits the free pool -
        exactly when `plan_dpd_decode_step` steps the whole set)."""
        bs = self.policy.block_size
        nmax = int(self.act_n[lanes].max())
        sub_f = self.act_f[lanes, :nmax]
        m = self._slots[:nmax][None, :] < self.act_n[lanes][:, None]
        ctx = (self.plen[sub_f] + self.emt[sub_f]) * m
        keys = (self.act_n[lanes] << _A2_BITS) | ctx.sum(axis=1)
        vals = _gather(keys, self._cdec_cache, self._cdec_compute, 2)
        t0 = self.t_b[lanes]
        self._charge(self._old_ci, lanes, t0, vals[:, 0], vals[:, 1])
        for i, r in enumerate(lanes.tolist()):   # aging credit, round start
            self.readyq[r].note_round(float(t0[i]))
        tnew = t0 + vals[:, 0]
        self.t_b[lanes] = tnew
        self._fast_decode_book(lanes, sub_f, m, m.astype(np.int64), tnew,
                               bs, self.used_b, nmax)

    def _slow_step_b(self, r: int) -> None:
        """Per-lane pool-B round under block pressure: the
        `plan_dpd_decode_step` grant loop, stalled sequences, and the
        fully-wedged swap-preemption (reship) path."""
        bs = self.policy.block_size
        nb = self._nb_b
        act = self.act_f[r, :int(self.act_n[r])].tolist()
        used = int(self.used_b[r])
        budget = nb - used
        granted: set[int] = set()
        for i in sorted(range(len(act)),
                        key=lambda i: (self.prio[act[i]], i)):
            f = act[i]
            need = blocks_for(int(self.kvt[f]) + 1, bs) - int(self.held[f])
            if need <= 0:
                granted.add(i)
            elif need <= budget:
                granted.add(i)
                budget -= need
        stepping = [act[i] for i in sorted(granted)]
        if not stepping:
            if len(act) <= 1:
                raise OutOfBlocks(
                    f"dpd decode pool of {nb} blocks cannot grow a "
                    f"single sequence (kv={int(self.kvt[act[0]])})")
            # fully wedged: swap out the worst-class youngest (reship)
            vi = max(range(len(act)),
                     key=lambda i: (self.prio[act[i]], i))
            f = act.pop(vi)
            used -= int(self.held[f])            # ledger.free
            self.held[f] = 0
            nbytes = dpd_kv_bytes(self.target_cfg, int(self.kvt[f]))
            tx = self.mode.interconnect.transfer_time(nbytes)
            self.link_bytes[r] += nbytes
            self.link_busy[r] += tx
            self.readyq[r].push(float(self.t_b[r]) + tx,
                                int(self.prio[f]), (f, int(self.emt[f])))
            self.n_ready[r] += 1
        else:
            a2 = sum(int(self.plen[f] + self.emt[f]) for f in stepping)
            hs = self._pricer.charges_for_key((0, 0, 0, len(stepping), a2))
            c = hs.charges[0][1]
            t0 = float(self.t_b[r])
            self._charge1(self._old_ci, r, t0, c.time_s, c.energy_j)
            self.readyq[r].note_round(t0)
            tnew = t0 + c.time_s
            self.t_b[r] = tnew
            for f in stepping:
                self.emt[f] += 1
                self.kvt[f] += 1
                need = blocks_for(int(self.kvt[f]), bs) - int(self.held[f])
                if need > 0:                     # granted above: must fit
                    self.held[f] += need
                    used += need
                self.tok[f] += 1
                self.last[f] = tnew
                if self.olen[f] - self.emt[f] <= 0:
                    self.finish[f] = tnew
                    used -= int(self.held[f])
                    self.held[f] = 0
                    act.remove(f)
        self.used_b[r] = used
        n = len(act)
        self.act_f[r, :n] = act
        self.act_n[r] = n

    def _advance_dpd_continuous(self, t_stop: float) -> None:
        """Disg-Pref-Decode under the continuous policy, lockstep.

        Pool A runs fully first (its schedule never depends on pool-B
        state - the same window-invariance argument as the scalar
        executor), then pool B admits/decodes in lockstep rounds."""
        R = self.R
        # ---- pool A: chunked batched prefill + FIFO link
        while True:
            live = self.t < t_stop
            if not live.any():
                break
            has_next, nxt_arr = self._next_arrivals()
            sub = live & has_next & (nxt_arr <= self.t)
            if sub.any():
                self._submit_due(sub)
                has_next, nxt_arr = self._next_arrivals()
            work = live & ((self.n_wait > 0) | (self.n_pref > 0))
            idle = live & ~work
            jump = idle & has_next & (nxt_arr < t_stop)
            if not (work.any() or jump.any()):
                break
            if jump.any():
                self.t[jump] = np.maximum(self.t[jump], nxt_arr[jump])
            if work.any():
                self.step[work] += 1
                for r in np.nonzero(work)[0].tolist():
                    self._step_pool_a(r)
            if self.iter_hook is not None:
                self.iter_hook(self)

        # ---- pool B: class-aware admission + block-granular decode
        mb = self.mode.max_batch
        nb_b = self._nb_b
        bs = self.policy.block_size
        while True:
            qlen = self.n_ready
            live = ((qlen > 0) | (self.act_n > 0)) & (self.t_b < t_stop)
            if not live.any():
                return
            progressed = False
            # admission (one lane at a time: peek_eligible scans a short
            # per-lane queue; the watermark keeps one growth block per
            # active sequence, exactly the scalar rule)
            adm = live & (qlen > 0) & (self.act_n < mb)
            for r in np.nonzero(adm)[0].tolist():
                q = self.readyq[r]
                tb = float(self.t_b[r])
                n = int(self.act_n[r])
                while n < mb:
                    entry = q.peek_eligible(tb)
                    if entry is None:
                        break
                    f, resume = entry[4]
                    kv0 = dpd_resume_kv(int(self.plen[f]), int(resume))
                    need = blocks_for(kv0, bs)
                    if need > nb_b - int(self.used_b[r]) - n - 1:
                        break                    # wait for blocks to free
                    self.kvt[f] = kv0
                    self.emt[f] = resume
                    self.held[f] = need          # pool-B ledger.allocate
                    self.used_b[r] += need
                    self.act_f[r, n] = f
                    n += 1
                    q.pop(entry)
                    self.n_ready[r] -= 1
                    progressed = True
                self.act_n[r] = n
            # idle lanes with queued entries jump to the next KV arrival;
            # an arrived entry that still cannot admit into an EMPTY pool
            # can never fit (the scalar executor's OutOfBlocks case)
            for r in np.nonzero(live & (self.act_n == 0))[0].tolist():
                q = self.readyq[r]
                if not len(q):
                    continue                     # waiting on pool A / link
                blocked = q.peek_eligible(float(self.t_b[r]))
                if blocked is not None:
                    f, resume = blocked[4]
                    raise OutOfBlocks(
                        "dpd decode pool cannot fit one sequence (need "
                        f"{blocks_for(int(self.plen[f]) + int(resume) - 1, bs)}"
                        f" blocks of {nb_b})")
                nxt = q.next_ready_s()
                if nxt < t_stop:
                    self.t_b[r] = nxt
                    progressed = True
            dec = live & (self.act_n > 0)
            if dec.any():
                dl = np.nonzero(dec)[0]
                nmax = int(self.act_n[dl].max())
                sub_f = self.act_f[dl, :nmax]
                m = self._slots[:nmax][None, :] < self.act_n[dl][:, None]
                need = (-(-(self.kvt[sub_f] + 1) // bs)
                        - self.held[sub_f]) * m
                allg = np.where(need > 0, need, 0).sum(axis=1) \
                    <= nb_b - self.used_b[dl]
                if allg.any():
                    self._fast_decode_b(dl[allg])
                for r in dl[~allg].tolist():
                    self._slow_step_b(r)
                progressed = True
            if self.iter_hook is not None:
                self.iter_hook(self)
            if not progressed:
                return                  # all blocked on horizon / pool A

    def ledger_populations(self) -> dict:
        """[R]-stacked block-ledger populations (continuous policy only).

        The lockstep core never binds a prefix cache, so the shared and
        retained populations are identically zero and the conservation
        invariant collapses to owned + free == num_blocks per lane;
        `owned` must also equal the summed arena `held` of the lane's
        live sequences (tests/test_vector_ledger_property.py asserts both
        at every lockstep iteration via `iter_hook`)."""
        if self.policy.kind != "continuous":
            raise ValueError("ledger populations need the continuous policy")
        out = {
            "owned": self.used.copy(),
            "shared": np.zeros(self.R, dtype=np.int64),
            "retained": np.zeros(self.R, dtype=np.int64),
            "free": self._kb.num_blocks - self.used,
            "num_blocks": self._kb.num_blocks,
        }
        if self.mode.kind == "dpd":
            out["pool_b"] = {
                "owned": self.used_b.copy(),
                "free": self._nb_b - self.used_b,
                "num_blocks": self._nb_b,
            }
        # chaos rows come from the delegated lane's REAL ledger (built by
        # the same batching.py builder, so num_blocks agrees); a lazily
        # unbuilt scheduler means nothing was ever admitted - all free
        for r, sim in self._chaos.items():
            sched = sim._sched_a if self.mode.kind == "dpd" else sim._sched
            if sched is not None:
                led = sched.ledger
                out["owned"][r] = led.used_blocks
                out["shared"][r] = led.shared_blocks
                out["retained"][r] = led.retained_blocks
                out["free"][r] = (led.num_blocks - led.used_blocks
                                  - led.shared_blocks - led.retained_blocks)
            if self.mode.kind == "dpd" and sim._ledger_b is not None:
                led_b = sim._ledger_b
                out["pool_b"]["owned"][r] = led_b.used_blocks
                out["pool_b"]["free"][r] = \
                    led_b.num_blocks - led_b.used_blocks
        return out

    # ------------------------------------------------------------ output
    def _segments_by_lane(self, ci: int):
        sl, s0, s1, se = self._segs[ci]
        if not sl:
            return None
        lane = np.concatenate(sl)
        t0 = np.concatenate(s0)
        t1 = np.concatenate(s1)
        e = np.concatenate(se)
        order = np.argsort(lane, kind="stable")   # append order within lane
        lane, t0, t1, e = lane[order], t0[order], t1[order], e[order]
        starts = np.searchsorted(lane, np.arange(self.R))
        ends = np.searchsorted(lane, np.arange(self.R), side="right")
        return lane, t0, t1, e, starts, ends

    @property
    def pending(self) -> int:
        """Requests submitted but not yet finished (all lanes); chaos
        lanes count through their scalar sim (aborted requests are
        resolved, not pending - ReplicaSim.pending)."""
        n = int(np.isnan(self.finish).sum())
        return n + sum(sim.pending for sim in self._chaos.values())

    @property
    def idle(self) -> bool:
        return self.pending == 0

    def results(self) -> list[SimResult]:
        """Materialize one `SimResult` per lane (ReplicaSim-compatible)."""
        segs = [self._segments_by_lane(ci) for ci in range(len(self.chip_names))] \
            if self._segs is not None else [None] * len(self.chip_names)
        # bulk ndarray->python conversion up front: per-element float()/int()
        # casts inside the listcomps dominate materialization at fleet scale
        ttft_l, fin_l = self.ttft.tolist(), self.finish.tolist()
        tok_l, first_l, last_l = (self.tok.tolist(), self.first.tolist(),
                                  self.last.tolist())
        seg_tuples = []
        for sg in segs:
            if sg is None:
                seg_tuples.append(None)
            else:
                _, t0, t1, en, st, en_idx = sg
                seg_tuples.append((list(zip(t0.tolist(), t1.tolist(),
                                            en.tolist())), st, en_idx))
        out = []
        for r in range(self.R):
            s, e = int(self.lane_start[r]), int(self.lane_end[r])
            traces = [
                ReqTrace(self.reqs[i], ttft_s=ttft_l[i], finish_s=fin_l[i],
                         tokens_out=tok_l[i], first_token_s=first_l[i],
                         last_token_s=last_l[i])
                for i in range(s, e)
            ]
            use = {}
            for ci, name in enumerate(self.chip_names):
                cu = ChipUse(float(self.busy[r, ci]),
                             float(self.energy[r, ci]))
                sg = seg_tuples[ci]
                if sg is not None:
                    tuples, st, en_idx = sg
                    cu.segments = tuples[int(st[r]):int(en_idx[r])]
                use[name] = cu
            if self.mode.kind == "dpd":
                duration = float(max(self.t[r], self.t_b[r], self.link_free[r]))
            else:
                duration = float(self.t[r])
            out.append(SimResult(
                self.mode, traces, use, duration,
                link_bytes=float(self.link_bytes[r]),
                link_busy_s=float(self.link_busy[r]),
                start_s=self.start_s))
        for r, sim in self._chaos.items():
            out[r] = sim.result()            # delegated lane, in place
        return out

    def merged(self) -> SimResult:
        return SimResult.merge(self.results())

    def stats(self) -> dict:
        """Array-level summary + conservation invariants (no materialization).

        Invariants asserted by tests/test_scale_smoke.py: every request
        finished after a drain, emitted exactly its output_len tokens, and
        per-chip busy seconds are non-negative and finite."""
        finished = ~np.isnan(self.finish)
        ttft = self.ttft[~np.isnan(self.ttft)].tolist()
        prio = self.prio.tolist()
        fin_mask = finished.tolist()
        fin_max = [float(np.nanmax(self.finish))] if finished.any() else []
        n_req = self.nflat
        n_fin = int(finished.sum())
        tok = int(self.tok.sum())
        exp = int(self.olen.sum())
        busy = {n: float(self.busy[:, i].sum())
                for i, n in enumerate(self.chip_names)}
        energy = {n: float(self.energy[:, i].sum())
                  for i, n in enumerate(self.chip_names)}
        link = float(self.link_bytes.sum())
        status = {"ok": 0, "cancelled": 0, "timed_out": 0, "killed": 0}
        chaos_ttft = []
        # chaos lanes (delegated scalar sims) fold into the same totals;
        # their aborted requests land in `status`, never in finished
        for sim in self._chaos.values():
            n_req += len(sim.traces)
            for tr in sim.traces:
                status[tr.status] += 1
                prio.append(class_priority(tr.req.slo_class))
                chaos_ttft.append(tr.ttft_s)
                done = not math.isnan(tr.finish_s) and tr.status == "ok"
                fin_mask.append(done)
                n_fin += done
                tok += tr.tokens_out
                exp += tr.req.output_len
                if not math.isnan(tr.ttft_s):
                    ttft.append(tr.ttft_s)
                if done:
                    fin_max.append(tr.finish_s)
            for name, use in sim.use.items():
                busy[name] = busy.get(name, 0.0) + use.busy_s
                energy[name] = energy.get(name, 0.0) + use.energy_j
            link += sim.link_bytes
        status["ok"] = n_req - sum(status.values()) + status["ok"]
        out = {
            "n_replicas": self.R,
            "n_requests": n_req,
            "finished": n_fin,
            "total_tokens": tok,
            "expected_tokens": exp,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else math.nan,
            "max_finish_s": max(fin_max) if fin_max else math.nan,
            "busy_s": busy,
            "energy_j": energy,
            "link_bytes": link,
            "status": status,
        }
        prio_a = np.asarray(prio, dtype=np.int64)
        fin_a = np.asarray(fin_mask, dtype=bool)
        ttft_all = np.concatenate([self.ttft, np.asarray(chaos_ttft)]) \
            if chaos_ttft else self.ttft
        per_class = {}
        for p in np.unique(prio_a).tolist():
            sel = prio_a == p
            done = fin_a & sel
            per_class[int(p)] = {
                "n": int(sel.sum()),
                "finished": int(done.sum()),
                "mean_ttft_s": float(ttft_all[done].mean())
                if done.any() else math.nan,
            }
        out["per_class"] = per_class
        return out
