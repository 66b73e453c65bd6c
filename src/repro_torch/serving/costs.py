"""Shared cost schedule: how one engine iteration is priced and placed.

The cluster simulator (simulator.py) and the real-compute engine
(engine.py) must price iterations *identically* - same chips charged, same
roofline costs, same serialization/overlap rules - or the simulator stops
being a faithful stand-in for the engine at scale (the engine<->simulator
parity test in tests/test_engine_sim_parity.py enforces this). This module
is the single source of truth for that schedule:

  prefill_charges     which chips a prefill admission charges, when, and
                      how long the admission occupies the engine loop
                      (spec serializes draft+target on the new chip; dsd
                      runs them on parallel pools)
  spec_round_charges  the draft K+1 sequential single-token steps + one
                      target verify pass of a speculative round
  spec_round_time     wall time of that round (dsd overlaps the probs
                      transfer behind the target forward, Fig. 7)
  dsd_link_bytes      token-id + draft-prob bytes crossing the link
  dpd_kv_bytes        KV cache + recurrent state shipped per request in
                      Disg-Pref-Decode

`perfmodel` owns the per-step rooflines; this module owns the *schedule*
built from them. All expressions are kept operation-for-operation equal to
the pre-refactor inlined versions so golden parity holds bit-exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.carbon import ChipSpec
from repro_torch.models.config import ModelConfig
from repro_torch.serving.perfmodel import (
    HybridKey,
    Interconnect,
    StepCost,
    calibration_state,
    decode_cost,
    dsd_round_time,
    hybrid_step_cost,
    hybrid_step_cost_from_key,
    hybrid_step_key,
    prefill_cost,
)

# (chip name, step cost, start offset relative to the admission instant)
Charge = tuple[str, StepCost, float]

# (chunk tokens, tokens already cached) - see perfmodel.hybrid_step_cost
ChunkSpec = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class PrefillSchedule:
    """One prefill admission: per-chip charges + loop occupancy."""

    charges: tuple[Charge, ...]
    duration_s: float


def prefill_charges(
    kind: str,
    target_cfg: ModelConfig,
    draft_cfg: Optional[ModelConfig],
    new_chip: ChipSpec,
    old_chip: Optional[ChipSpec],
    prompt_len: int,
) -> PrefillSchedule:
    """Schedule of one prefill admission for any serving kind.

    standalone/dpd: one target prefill on the new chip (dpd's KV link
    transfer is a separate pipelined resource, priced by the caller via
    `dpd_kv_bytes`). spec: draft prefill serialized after the target on the
    same chip. dsd: draft prefill on the old pool in parallel."""
    c_t = prefill_cost(target_cfg, new_chip, 1, prompt_len)
    charges: list[Charge] = [(new_chip.name, c_t, 0.0)]
    dur = c_t.time_s
    if kind == "spec":
        c_d = prefill_cost(draft_cfg, new_chip, 1, prompt_len)
        charges.append((new_chip.name, c_d, c_t.time_s))
        dur += c_d.time_s                      # serialized on one chip
    elif kind == "dsd":
        c_d = prefill_cost(draft_cfg, old_chip, 1, prompt_len)
        charges.append((old_chip.name, c_d, 0.0))
        dur = max(dur, c_d.time_s)             # parallel pools
    return PrefillSchedule(tuple(charges), dur)


def spec_round_charges(
    kind: str,
    target_cfg: ModelConfig,
    draft_cfg: ModelConfig,
    new_chip: ChipSpec,
    old_chip: Optional[ChipSpec],
    batch: int,
    ctx: int,
    k: int,
) -> tuple[ChipSpec, StepCost, StepCost]:
    """(draft chip, draft cost, target cost) of one speculative round.

    The DRAFT is autoregressive: K+1 sequential single-token steps, each
    re-reading the weights; the TARGET verifies all K+1 positions in one
    pass."""
    draft_chip = new_chip if kind == "spec" else old_chip
    c_d1 = decode_cost(draft_cfg, draft_chip, batch, ctx)
    c_d = dataclasses.replace(c_d1, time_s=c_d1.time_s * (k + 1),
                              energy_j=c_d1.energy_j * (k + 1))
    c_t = decode_cost(target_cfg, new_chip, batch, ctx, new_tokens=k + 1)
    return draft_chip, c_d, c_t


def spec_round_time(
    kind: str,
    c_draft: StepCost,
    c_target: StepCost,
    interconnect: Interconnect,
    ids_bytes: float,
    probs_bytes: float,
    overlap: bool = True,
) -> float:
    """Wall time of one round: colocated spec serializes draft+target;
    dsd follows the Fig. 7 communication-overlap schedule."""
    if kind == "spec":
        return c_draft.time_s + c_target.time_s
    return dsd_round_time(c_draft.time_s, c_target.time_s, interconnect,
                          ids_bytes, probs_bytes, overlap=overlap)


@dataclasses.dataclass(frozen=True)
class HybridSchedule:
    """One continuous-batching step: per-chip charges + wall occupancy."""

    charges: tuple[Charge, ...]
    duration_s: float
    link_ids_bytes: float = 0.0      # dsd: token ids shipped this step
    link_probs_bytes: float = 0.0    # dsd: draft probs shipped this step


def _scaled(cost: StepCost, factor: int) -> StepCost:
    return dataclasses.replace(cost, time_s=cost.time_s * factor,
                               energy_j=cost.energy_j * factor)


def hybrid_step_charges(
    kind: str,
    target_cfg: ModelConfig,
    draft_cfg: Optional[ModelConfig],
    new_chip: ChipSpec,
    old_chip: Optional[ChipSpec],
    chunks: "tuple[ChunkSpec, ...]",
    decode_ctxs: "tuple[int, ...]",
    k: int,
    interconnect: Interconnect,
    overlap: bool = True,
) -> HybridSchedule:
    """Price one continuous-batching step for any serving kind.

    The single source of truth for BOTH executors' continuous policy
    (ReplicaSim._advance_continuous and the engine's continuous step) -
    mirroring how `prefill_charges`/`spec_round_charges` price the
    serialized policy. Decode KV traffic is summed per sequence (exact
    under the roofline), unlike the serialized path's batch-mean context.

    Prefix-cache reuse is priced through the chunks' CACHED dimension:
    a matched prompt prefix never appears in any chunk's token count -
    it enters each chunk as `ctx_cached` context, so it costs one KV
    re-read per attending step (perfmodel.prefix_reuse_bytes) instead of
    prefill FLOPs + writes. No separate "cache hit" charge exists.

      standalone  one hybrid pass on the new chip
      spec        draft K+1 decode steps, then the target hybrid
                  verify+chunk pass, then the draft's own chunk prefill -
                  all serialized on the new chip (a pure-prefill step
                  degenerates to `prefill_charges`'s target-then-draft)
      dsd         draft decode steps + draft chunk prefill on the old
                  pool; target hybrid pass on the new pool; the Fig. 7
                  overlap schedule hides the probs transfer behind the
                  target pass, and the draft chunk prefill hides behind it
                  too (parallel pools)
      dpd         prefill chunks charge the new pool, decode charges the
                  old pool; `duration_s` is their serialized sum - the
                  single-clock engine's view. The two-pool simulator
                  prices each pool separately via `hybrid_step_cost` and
                  only matches the engine on pipelined (batch-1) runs,
                  like the serialized policy.
    """
    return hybrid_charges_from_key(kind, target_cfg, draft_cfg, new_chip,
                                   old_chip, hybrid_step_key(chunks, decode_ctxs),
                                   k, interconnect, overlap=overlap)


def hybrid_charges_from_key(
    kind: str,
    target_cfg: ModelConfig,
    draft_cfg: Optional[ModelConfig],
    new_chip: ChipSpec,
    old_chip: Optional[ChipSpec],
    key: HybridKey,
    k: int,
    interconnect: Interconnect,
    overlap: bool = True,
) -> HybridSchedule:
    """`hybrid_step_charges` from precomputed `hybrid_step_key` aggregates.

    The key fully determines the schedule for a fixed serving
    configuration (a step's chunk/decode composition is all the branches
    below look at), which is what lets `HybridPricer` memoize whole
    schedules and the lockstep fleet core price steps without ever
    materializing per-chunk tuples. Schedulers never emit zero-token
    chunks, so `chunk_tok > 0` is "the step has chunks"."""
    chunk_tok, a1, s_sc, n_dec, a2 = key
    chunk_key: HybridKey = (chunk_tok, a1, s_sc, 0, 0)
    dec_key: HybridKey = (0, 0, 0, n_dec, a2)

    if kind == "standalone":
        c = hybrid_step_cost_from_key(target_cfg, new_chip, key)
        return HybridSchedule(((new_chip.name, c, 0.0),), c.time_s)

    if kind == "dpd":
        charges: list[Charge] = []
        t = 0.0
        if chunk_tok:
            cp = hybrid_step_cost_from_key(target_cfg, new_chip, chunk_key)
            charges.append((new_chip.name, cp, 0.0))
            t += cp.time_s
        if n_dec:
            cd = hybrid_step_cost_from_key(target_cfg, old_chip, dec_key)
            charges.append((old_chip.name, cd, t))
            t += cd.time_s
        return HybridSchedule(tuple(charges), t)

    if kind == "spec":
        charges = []
        t = 0.0
        if n_dec:
            d1 = hybrid_step_cost_from_key(draft_cfg, new_chip, dec_key)
            cd = _scaled(d1, k + 1)               # K+1 sequential draft steps
            charges.append((new_chip.name, cd, t))
            t += cd.time_s
        ct = hybrid_step_cost_from_key(target_cfg, new_chip, key,
                                       new_tokens=k + 1)
        charges.append((new_chip.name, ct, t))
        t += ct.time_s
        if chunk_tok:
            cdc = hybrid_step_cost_from_key(draft_cfg, new_chip, chunk_key)
            charges.append((new_chip.name, cdc, t))
            t += cdc.time_s
        return HybridSchedule(tuple(charges), t)

    if kind == "dsd":
        charges = []
        ct = hybrid_step_cost_from_key(target_cfg, new_chip, key,
                                       new_tokens=k + 1)
        if not n_dec:
            # pure prefill: pools run in parallel (prefill_charges' dsd)
            cdc = hybrid_step_cost_from_key(draft_cfg, old_chip, chunk_key)
            charges.append((new_chip.name, ct, 0.0))
            charges.append((old_chip.name, cdc, 0.0))
            return HybridSchedule(tuple(charges), max(ct.time_s, cdc.time_s))
        d1 = hybrid_step_cost_from_key(draft_cfg, old_chip, dec_key)
        cd = _scaled(d1, k + 1)
        ids_b, probs_b = dsd_link_bytes(draft_cfg, n_dec, k)
        round_t = dsd_round_time(cd.time_s, ct.time_s, interconnect,
                                 ids_b, probs_b, overlap=overlap)
        charges.append((old_chip.name, cd, 0.0))
        charges.append((new_chip.name, ct,
                        cd.time_s + interconnect.transfer_time(ids_b)))
        t_old = cd.time_s
        if chunk_tok:
            # the draft's chunk prefill overlaps the target pass (parallel
            # pools); it extends the round only if the old pool is the
            # straggler
            cdc = hybrid_step_cost_from_key(draft_cfg, old_chip, chunk_key)
            charges.append((old_chip.name, cdc, t_old))
            t_old += cdc.time_s
        return HybridSchedule(tuple(charges), max(round_t, t_old),
                              link_ids_bytes=ids_b, link_probs_bytes=probs_b)

    raise ValueError(f"unknown serving kind: {kind!r}")


# --------------------------------------------------------------------------
# Keyed schedule memo
# --------------------------------------------------------------------------

# Benchmark hook: `pricer_bypass()` makes every `HybridPricer` call re-price
# instead of hitting its cache, so the sweep can measure the scalar
# executor's pre-memo cost without a second code path.
_PRICER_BYPASS = False


@dataclasses.dataclass
class _BypassCtx:
    def __enter__(self):
        global _PRICER_BYPASS
        self._saved = _PRICER_BYPASS
        _PRICER_BYPASS = True
        return self

    def __exit__(self, *exc):
        global _PRICER_BYPASS
        _PRICER_BYPASS = self._saved
        return False


def pricer_bypass() -> _BypassCtx:
    """Context manager: disable HybridPricer cache hits (benchmarking only)."""
    return _BypassCtx()


class HybridPricer:
    """Keyed memo over `hybrid_step_charges` for one serving configuration.

    Continuous executors re-price identical (chunk, decode-context)
    compositions every step - a steady decode pool hits the same
    `hybrid_step_key` for hundreds of iterations, and replicas of one
    config group share compositions across lanes. The memo key is the
    exact integer aggregate tuple (see `perfmodel.hybrid_step_key`), so a
    cache hit returns the *same* `HybridSchedule` object the scalar
    function would have built - bit-exactness is by construction, not by
    tolerance.

    `calibrated()` swaps perfmodel's module constants at call time;
    entries are validated against `perfmodel.calibration_state()` and the
    cache drops wholesale when the constants change, so a pricer never
    serves a stale roofline across calibration scopes.
    """

    __slots__ = ("kind", "target_cfg", "draft_cfg", "new_chip", "old_chip",
                 "k", "interconnect", "overlap", "_cache", "_calib",
                 "hits", "misses")

    def __init__(self, kind: str, target_cfg: ModelConfig,
                 draft_cfg: Optional[ModelConfig], new_chip: ChipSpec,
                 old_chip: Optional[ChipSpec], k: int = 0,
                 interconnect: Optional[Interconnect] = None,
                 overlap: bool = True):
        self.kind = kind
        self.target_cfg = target_cfg
        self.draft_cfg = draft_cfg
        self.new_chip = new_chip
        self.old_chip = old_chip
        self.k = k
        self.interconnect = interconnect if interconnect is not None else Interconnect()
        self.overlap = overlap
        self._cache: dict[HybridKey, HybridSchedule] = {}
        self._calib = calibration_state()
        self.hits = 0
        self.misses = 0

    def charges_for_key(self, key: HybridKey) -> HybridSchedule:
        calib = calibration_state()
        if calib != self._calib:
            self._cache.clear()
            self._calib = calib
        sched = self._cache.get(key)
        if sched is None or _PRICER_BYPASS:
            sched = hybrid_charges_from_key(
                self.kind, self.target_cfg, self.draft_cfg, self.new_chip,
                self.old_chip, key, self.k, self.interconnect,
                overlap=self.overlap)
            self._cache[key] = sched
            self.misses += 1
        else:
            self.hits += 1
        return sched

    def charges(self, chunks: "tuple[ChunkSpec, ...]",
                decode_ctxs: "tuple[int, ...]") -> HybridSchedule:
        return self.charges_for_key(hybrid_step_key(chunks, decode_ctxs))


_SHARED_PRICERS: dict = {}


def shared_pricer(kind: str, target_cfg: ModelConfig,
                  draft_cfg: Optional[ModelConfig], new_chip: ChipSpec,
                  old_chip: Optional[ChipSpec], k: int = 0,
                  interconnect: Optional[Interconnect] = None,
                  overlap: bool = True) -> HybridPricer:
    """Process-wide `HybridPricer` registry.

    Every consumer of the continuous cost model - `ReplicaSim`'s scalar
    executors, the lockstep fleet core, `estimate_service_s`, and the
    allocator's `build_gpu_info` profile grids - prices through one shared
    memo per serving configuration, so an autoscale re-solve stops
    re-deriving rooflines the fleet simulation already priced. Keyed on
    the (frozen, hashable) config/chip/link objects themselves, never on
    `id()`, so a garbage-collected config can't alias a live entry."""
    key = (kind, target_cfg, draft_cfg, new_chip, old_chip, k,
           interconnect if interconnect is not None else Interconnect(), overlap)
    p = _SHARED_PRICERS.get(key)
    if p is None:
        p = _SHARED_PRICERS[key] = HybridPricer(
            kind, target_cfg, draft_cfg, new_chip, old_chip, k=k,
            interconnect=interconnect, overlap=overlap)
    return p


def dsd_link_bytes(draft_cfg: ModelConfig, batch: int, k: int) -> tuple[int, int]:
    """(token-id bytes, fp16 draft-prob bytes) one dsd round ships."""
    return batch * k * 4, batch * k * draft_cfg.vocab_size * 2


def dpd_kv_bytes(cfg: ModelConfig, prompt_len: int) -> float:
    """Bytes Disg-Pref-Decode ships per request: prompt KV + recurrent state."""
    return prompt_len * cfg.kv_bytes_per_token() + cfg.state_bytes()
