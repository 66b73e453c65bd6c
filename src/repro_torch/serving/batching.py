"""Iteration-level continuous batching: policy, KV-block ledger, scheduler.

This module is the single scheduling brain behind BOTH executors. The
cluster simulator (`simulator.py:ReplicaSim(batching="continuous")`) and
the real-compute engine (`engine.py:ServingEngine(batching=...)`) drive
the same `ContinuousScheduler` object model, so the two make *identical*
admission / chunking / preemption decisions and stay parity-comparable
(tests/test_engine_sim_parity.py); only what they do with a `StepPlan`
differs (the simulator prices it, the engine also runs real forwards).

The policy is vLLM/Sarathi-style hybrid batching:

  - every step carries ALL running sequences as decode participants (one
    decode slot each; a speculative round's verify chunk still counts as
    one slot), plus prefill *chunks* of at most `chunk_tokens` per request
    filling the remaining per-step `token_budget`;
  - prompts are processed in FCFS chunks instead of one stop-the-world
    pass, so decodes never stall behind a long prompt and TTFT under
    bursts stops collapsing (the PR-4 headline, benchmarks/batching_sweep);
  - KV admission is block-granular, mirroring `PagedKVPool`
    (`blocks_needed`/`can_admit`/free-on-finish) through the storage-free
    `BlockLedger`: a chunk is admitted only if its blocks fit next to a
    worst-case growth reservation for the running decodes;
  - when decode growth still outruns the pool, the scheduler PREEMPTS
    (vLLM recompute-style: the victim's blocks are freed and its prompt +
    generated prefix re-prefills later); the pool must fit at least one
    max-length sequence or `OutOfBlocks` surfaces.

SLO classes (priority scheduling, the PR-5 layer): every `SchedSeq`
carries a `priority` (0 = most latency-critical; executors map it from
`Request.slo_class` - serving/workload.py). The scheduler is strict-
priority with aging:

  - ADMISSION orders the waiting queue by effective priority, where a
    sequence waiting `age_steps` scheduler steps is promoted one level
    (so a relaxed request behind an endless stream of tight arrivals
    still schedules - no starvation); ties and single-class workloads
    keep exact submission order, so the pre-class schedule is replayed
    bit-identically when every request is one class;
  - DECODE-SLOT COMPOSITION is shortest-remaining-first within priority:
    when more sequences are running than the step's token budget has
    slots, the slots go to the highest classes first and, within a
    class, to the sequences closest to finishing (SRF drains the decode
    pool fastest, freeing blocks for waiting prefills);
  - PREEMPTION is class-ordered: victims are drawn from the worst
    (most relaxed) class first - a tight sequence is never evicted while
    a relaxed one holds blocks - and within a class least-sunk-first
    (partial prefills, then deferred/youngest decodes);
  - a waiting sequence of strictly better effective priority than the
    worst block-holder may preempt it AT ADMISSION when no chunk fits
    otherwise, so a full relaxed decode pool cannot gate a tight TTFT
    behind whole relaxed generations (and cannot deadlock admission -
    preemption always makes progress).

`BatchPolicy(kind="serialized")` routes executors to their legacy loops
(one whole prompt at a time, prefill priority, batch-mean decode context)
which stay bit-exact against tests/data/golden_simulate.json.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.carbon import ChipSpec
from repro_torch.models.config import ModelConfig

# re-use the engine pool's error type so callers catch one exception
from repro_torch.serving.kv_cache import OutOfBlocks
from repro_torch.serving.prefix_cache import PrefixCache


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Knobs of the iteration-level scheduler.

    kind          "continuous" (hybrid chunked-prefill batching) or
                  "serialized" (legacy loop: whole-prompt prefill priority)
    chunk_tokens  max prefill tokens one request contributes per step
    token_budget  max new tokens per step (decode slots + chunk tokens);
                  bounds step latency, hence TPOT under chunked prefill
    block_size    KV block granularity (tokens per block)
    num_blocks    KV pool size in blocks; None derives it from the decode
                  chip's HBM next to the weights (`default_kv_blocks`)
    age_steps     scheduler steps a waiting sequence spends per one-level
                  priority promotion (anti-starvation aging; only
                  relevant on mixed-class workloads)
    prefix_cache  enable cross-request prefix KV caching: finished
                  prompts' blocks are RETAINED in a radix cache and later
                  prompts sharing a block-aligned prefix skip its prefill
                  (serving/prefix_cache.py). Off by default - the PR-5
                  schedule replays bit-exactly with it off, and also with
                  it ON on a zero-share workload (retained blocks count
                  as free for every admission decision).
    retain_frac   ceiling on the retained population, as a fraction of
                  `num_blocks`, reached when grid carbon intensity is at
                  its greenest; the effective cap ramps down to 0 as the
                  trace approaches `PrefixCache.ci_high`
    tpot_guard_frac  per-class TPOT guard inside a hybrid step: when a
                  step's decode participants include a class strictly
                  WORSE than a prefill chunk's class, cumulative chunk
                  tokens from those better classes are capped at this
                  fraction of `token_budget` - a tight prefill stream can
                  then stretch a relaxed decode's step time by at most
                  that share instead of unboundedly. 1.0 (default)
                  disables the guard (bit-exact with prior schedules);
                  single-class workloads are unaffected at any value.
    """

    kind: str = "continuous"
    chunk_tokens: int = 256
    token_budget: int = 512
    block_size: int = 16
    num_blocks: Optional[int] = None
    age_steps: int = 512
    prefix_cache: bool = False
    retain_frac: float = 0.5
    tpot_guard_frac: float = 1.0

    def __post_init__(self):
        if self.kind not in ("serialized", "continuous"):
            raise ValueError(f"unknown batching kind: {self.kind!r}")
        if self.kind == "continuous":
            if self.chunk_tokens < 1:
                raise ValueError(f"chunk_tokens must be >= 1: {self.chunk_tokens}")
            if self.token_budget < 1:
                raise ValueError(f"token_budget must be >= 1: {self.token_budget}")
            if self.block_size < 1:
                raise ValueError(f"block_size must be >= 1: {self.block_size}")
            if self.age_steps < 1:
                raise ValueError(f"age_steps must be >= 1: {self.age_steps}")
            if not 0.0 <= self.retain_frac <= 1.0:
                raise ValueError(
                    f"retain_frac must be in [0, 1]: {self.retain_frac}")
            if not 0.0 < self.tpot_guard_frac <= 1.0:
                raise ValueError(
                    f"tpot_guard_frac must be in (0, 1]: {self.tpot_guard_frac}")

    @staticmethod
    def from_dataset(ds, block_size: int = 16,
                     num_blocks: Optional[int] = None,
                     decode_slots: int = 64,
                     age_steps: int = 512) -> "BatchPolicy":
        """Workload-adaptive knobs from the dataset's prompt percentiles.

        The default (256, 512) policy is tuned for chatbot-length prompts;
        chunked prefill re-reads the weights once per chunk, so a
        long-prompt workload (longbench: P50 prompt ~1.5k tokens) pays ~6
        weight reads per median prompt under it. This derives:

          chunk_tokens  covers the P50 prompt in ONE chunk (rounded up to
                        a multiple of 64, floored at the default 256)
          token_budget  covers a P75 prompt's chunk plus `decode_slots`
                        decode tokens, so admission of a long prompt does
                        not starve the step of decode slots

        `ds` is any object with `p50`/`p75` (prompt, output) percentile
        pairs - `workload.Dataset` in practice."""
        rnd = lambda v: int(-(-v // 64) * 64)           # noqa: E731
        chunk = max(256, rnd(ds.p50[0]))
        budget = max(512, rnd(min(ds.p75[0], 4 * chunk)) + decode_slots)
        return BatchPolicy(chunk_tokens=chunk, token_budget=budget,
                           block_size=block_size, num_blocks=num_blocks,
                           age_steps=age_steps)


SERIALIZED = BatchPolicy(kind="serialized")


def resolve_batch_policy(batching: "BatchPolicy | str | None",
                         default: str = "serialized") -> BatchPolicy:
    """Normalize a `batching=` argument: None -> `default`, str -> policy.

    Unknown kind strings raise (BatchPolicy validation) - a typo must not
    silently fall back to the legacy scheduler."""
    if batching is None:
        batching = default
    if isinstance(batching, str):
        return BatchPolicy(kind=batching)
    return batching


def default_kv_blocks(cfg: ModelConfig, chip: ChipSpec, block_size: int,
                      extra_weights_bytes: float = 0.0,
                      dtype_bytes: int = 2,
                      reserve_frac: float = 0.1) -> int:
    """KV blocks that fit in `chip` HBM next to the weights.

    The block-pool analogue of `perfmodel.max_concurrency`: same reserve
    fraction, but capacity is counted in blocks so admission can be
    block-granular. Recurrent families (kv_bytes_per_token == 0) get an
    effectively unlimited pool - their per-sequence state is seq-granular
    and already bounded by `max_batch`."""
    weights = cfg.param_count() * dtype_bytes + extra_weights_bytes
    free = chip.hbm_capacity * (1.0 - reserve_frac) - weights
    per_block = block_size * cfg.kv_bytes_per_token(dtype_bytes)
    if free <= 0:
        return 0
    if per_block <= 0:
        return 1_000_000
    return max(int(free // per_block), 0)


def prompt_chunks(prompt_len: int,
                  chunk_tokens: int) -> "tuple[tuple[int, int], ...]":
    """(chunk, cached-ctx) splits of one prompt under the chunk size - the
    shape `perfmodel.hybrid_step_cost` prices and the scheduler emits for
    an uncontended prefill."""
    return tuple((min(chunk_tokens, prompt_len - s), s)
                 for s in range(0, prompt_len, chunk_tokens))


# ---------------------------------------------------------------------------
# Pure plan arithmetic (shared by both executors AND the lockstep fleet core)
# ---------------------------------------------------------------------------
# Every scheduling decision below is branch-free integer arithmetic over a
# sequence's (priority, progress, kv) scalars. `ContinuousScheduler`,
# `plan_dpd_decode_step`, and `DpdReadyQueue` call these per sequence; the
# vectorized continuous executor (serving/vector_core.py) calls the SAME
# functions from its per-lane planner and mirrors them as array expressions
# on its fast paths - one definition, so the two executors cannot drift.

def blocks_for(tokens: int, block_size: int) -> int:
    """KV blocks covering `tokens` (ceil-div; `BlockLedger.blocks_needed`)."""
    return -(-tokens // block_size)


def aged_priority(priority: int, waited: int, age_steps: int) -> int:
    """Effective class after anti-starvation aging: one level of promotion
    per `age_steps` scheduler steps (pool-B rounds for dpd) spent waiting,
    floored at the best class 0."""
    return max(priority - waited // age_steps, 0)


def decode_slot_count(token_budget: int, decode_tokens: int) -> int:
    """Decode slots one step's token budget carries (>= 1)."""
    return max(token_budget // decode_tokens, 1)


def chunk_take(chunk_tokens: int, prefill_target: int, done: int,
               budget: int, guard_room: int) -> int:
    """Prefill tokens one sequence contributes this step: its per-step
    chunk size, capped by remaining work, step budget, and TPOT guard."""
    return min(chunk_tokens, prefill_target - done, budget, guard_room)


def growth_blocks(kv: int, decode_tokens: int, held: int,
                  block_size: int) -> int:
    """Worst-case NEW blocks one decode participant may pull this step."""
    return blocks_for(kv + decode_tokens, block_size) - held


def guard_cap_tokens(tpot_guard_frac: float, token_budget: int) -> int:
    """Cumulative chunk-token cap the TPOT guard imposes per step."""
    return int(tpot_guard_frac * token_budget)


def recompute_target(prompt_len: int, emitted: int) -> int:
    """Tokens a preempted sequence must re-prefill (vLLM recompute
    semantics: prompt + generated prefix, minus the token the resumed
    decode re-emits)."""
    return prompt_len + max(emitted - 1, 0)


def dpd_resume_kv(prompt_len: int, resume_emitted: int) -> int:
    """KV tokens a dpd pool-B (re)admission starts with: the shipped
    prompt KV plus the already-emitted prefix, minus the re-decoded one."""
    return prompt_len + resume_emitted - 1


def _maybe_cache(policy: BatchPolicy, ledger: "BlockLedger",
                 ci_trace) -> "Optional[PrefixCache]":
    """The policy's prefix cache bound to `ledger`, or None when off."""
    if not policy.prefix_cache:
        return None
    return PrefixCache(ledger, policy.block_size, policy.retain_frac,
                       ci_trace=ci_trace)


def build_single_pool_scheduler(
    policy: BatchPolicy,
    kind: str,
    max_batch: int,
    spec_k: int,
    target_cfg: ModelConfig,
    draft_cfg: Optional[ModelConfig],
    new_chip: ChipSpec,
    ci_trace=None,
) -> "ContinuousScheduler":
    """The single-pool hybrid scheduler for standalone/spec/dsd engines.

    ONE constructor for BOTH executors (ReplicaSim and ServingEngine):
    ledger sizing, decode growth reservation, and the mix_decode choice
    live here, so the two cannot drift apart and every scheduling decision
    stays parity-comparable (tests/test_engine_sim_parity.py).

    Ledger sizing: `policy.num_blocks` wins when set; otherwise the pool
    is derived from the decode chip's HBM next to the weights. For `spec`
    the draft colocates on the new chip - its weights shrink the pool and
    its KV rides next to the target's, so one block effectively stores
    both models' per-token slices.
    """
    blocks = policy.num_blocks
    if kind == "spec" and draft_cfg is not None:
        if blocks is None:
            free = new_chip.hbm_capacity * 0.9 - (
                target_cfg.param_count() * 2 + draft_cfg.param_count() * 2)
            per_block = policy.block_size * (
                target_cfg.kv_bytes_per_token()
                + draft_cfg.kv_bytes_per_token())
            blocks = 0 if free <= 0 else (
                1_000_000 if per_block <= 0
                else max(int(free // per_block), 0))
    elif blocks is None:
        blocks = default_kv_blocks(target_cfg, new_chip, policy.block_size)
    spec_kind = kind in ("spec", "dsd")
    ledger = BlockLedger(blocks, policy.block_size)
    return ContinuousScheduler(
        policy, max_batch, ledger,
        decode_tokens=spec_k + 1 if spec_kind else 1,
        mix_decode=not spec_kind,
        cache=_maybe_cache(policy, ledger, ci_trace))


def build_dpd_prefill_scheduler(
    policy: BatchPolicy,
    max_batch: int,
    target_cfg: ModelConfig,
    new_chip: ChipSpec,
    ci_trace=None,
) -> "ContinuousScheduler":
    """The dpd prefill-pool (pool A) scheduler, shared by both executors.

    The prefill pool has no decodes to stall, so per-seq chunking buys
    nothing there: batch whole prompts under the step token budget
    (chunks still split prompts longer than the budget). Its ledger is
    always derived from the *new* chip's HBM - `policy.num_blocks`
    describes the decode pool (pool B), the binding KV resource in dpd.

    The prefix cache (when enabled) lives HERE: prefill is what matched
    blocks skip, so pool A retains finished prompts' KV; the decode pool
    never caches (its blocks turn over with generation, not prompts).
    The full prompt's KV still ships over the link regardless of match -
    only the prefill compute is elided."""
    pol_a = dataclasses.replace(policy, chunk_tokens=policy.token_budget)
    ledger = BlockLedger(
        default_kv_blocks(target_cfg, new_chip, policy.block_size),
        policy.block_size)
    return ContinuousScheduler(
        pol_a, max_batch, ledger, 1,
        cache=_maybe_cache(pol_a, ledger, ci_trace))


def build_dpd_decode_ledger(
    policy: BatchPolicy,
    target_cfg: ModelConfig,
    old_chip: ChipSpec,
) -> BlockLedger:
    """The dpd decode-pool (pool B) block ledger, shared by both executors."""
    blocks = policy.num_blocks
    if blocks is None:
        blocks = default_kv_blocks(target_cfg, old_chip, policy.block_size)
    return BlockLedger(blocks, policy.block_size)


def plan_dpd_decode_step(active: "list[SchedSeq]", ledger: "BlockLedger",
                         ) -> "tuple[list[SchedSeq], Optional[SchedSeq]]":
    """One dpd pool-B round's composition, shared by BOTH executors.

    (stepping, wedge_victim): sequences not at a block boundary decode
    for free; boundary-crossers get the free blocks class-first (tight
    before relaxed), oldest within a class; the rest stall this round.
    When nothing can step (zero free blocks, every sequence at a
    boundary) the worst-class youngest sequence is returned as the
    swap-preemption victim - a tight seq is never reshipped while a
    relaxed one holds blocks - or None when only one sequence is active
    (the caller's OutOfBlocks case)."""
    budget = ledger.free_blocks
    granted: set[int] = set()
    for i in sorted(range(len(active)),
                    key=lambda i: (active[i].priority, i)):
        seq = active[i]
        need = ledger.blocks_needed(seq.kv + 1) - ledger.held(seq.sid)
        if need <= 0:
            granted.add(i)
        elif need <= budget:
            granted.add(i)
            budget -= need
    stepping = [active[i] for i in sorted(granted)]
    if stepping or len(active) <= 1:
        return stepping, None
    return [], max(enumerate(active),
                   key=lambda t: (t[1].priority, t[0]))[1]


class DpdReadyQueue:
    """Class-aware dpd pool-B admission queue, shared by BOTH executors.

    Replaces the plain FIFO across the KV link: admission picks the best
    (effective-class, ready-time, push-order) among the entries whose KV
    has ARRIVED (`ready_s <= now`), so a tight sequence waiting on the
    link-side queue is admitted ahead of relaxed ones that shipped
    earlier. Within a class, KV-arrival time then push order tie-break -
    a single-class stream therefore reduces exactly to the old FIFO.

    Aging mirrors the waiting-queue rule of `ContinuousScheduler`
    (`age_steps` pool-B ROUNDS per one-level promotion, floor 0), with a
    window-invariant stamp: an entry's credit counts only the decode
    rounds that ran while its KV was already arrived (`note_round` checks
    `ready_s <= round start`). Push order, round times, and arrival times
    are all independent of where `advance_to` windows split - pool A's
    schedule never depends on pool-B state - so windowed `advance_to ==
    drain` is preserved by construction (tests/test_dpd_ready_queue.py).

    Head-of-line semantics are preserved: when the best eligible entry
    does not fit the block watermark the caller STALLS admission rather
    than skipping down-queue - overtaking would re-introduce the
    class-inversion this queue exists to remove.
    """

    def __init__(self, age_steps: int):
        if age_steps < 1:
            raise ValueError(f"age_steps must be >= 1: {age_steps}")
        self.age_steps = age_steps
        # [ready_s, priority, push idx, rounds waited while ready, item]
        self._entries: list[list] = []
        self._idx = 0

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, ready_s: float, priority: int, item) -> None:
        self._entries.append([ready_s, priority, self._idx, 0, item])
        self._idx += 1

    def note_round(self, round_start_s: float) -> None:
        """One pool-B decode round ran; credit the entries it kept waiting."""
        for e in self._entries:
            if e[0] <= round_start_s:
                e[3] += 1

    def _key(self, e: list) -> tuple[int, float, int]:
        return (aged_priority(e[1], e[3], self.age_steps), e[0], e[2])

    def peek_eligible(self, now_s: float) -> "Optional[list]":
        """Best arrived entry (admission order), or None; does not pop."""
        best = None
        for e in self._entries:
            if e[0] <= now_s and (best is None
                                  or self._key(e) < self._key(best)):
                best = e
        return best

    def pop(self, entry: list):
        self._entries.remove(entry)
        return entry[4]

    def next_ready_s(self) -> Optional[float]:
        """Earliest KV arrival over ALL entries (the idle-jump target)."""
        return min((e[0] for e in self._entries), default=None)

    def purge(self, pred) -> list:
        """Remove every entry whose item matches `pred`; return the items.
        Fault/cancel path: a killed replica or an aborted request must not
        leave shipped-KV entries behind to be admitted later."""
        hit = [e for e in self._entries if pred(e[4])]
        for e in hit:
            self._entries.remove(e)
        return [e[4] for e in hit]


# ---------------------------------------------------------------------------
# Block ledger: PagedKVPool's accounting without the storage
# ---------------------------------------------------------------------------
class BlockLedger:
    """Block-table accounting mirror of `PagedKVPool`.

    Same admission arithmetic (`blocks_needed`, `can_admit`), same
    alloc/extend/free lifecycle, no K/V arrays - the simulator runs
    admission against this, the engine against the real pool, and the
    shared scheduler keeps the two in lockstep. `peak_used` records the
    high-water mark for the block-budget property test.

    With a `PrefixCache` bound (`bind_cache`), the pool splits into FOUR
    populations whose sum is `num_blocks` at every step (the conservation
    invariant of tests/test_prefix_property.py):

      owned      (`used_blocks`)    blocks a live sequence allocated
      shared     (`shared_blocks`)  distinct cached blocks some live
                                    sequence holds a reference on
      retained   (`retained_blocks`) cached blocks nobody references
      physical-free (`physical_free`)

    `free_blocks` counts retained blocks as FREE: they are always
    reclaimable ahead of preempting an active sequence, so every
    admission / growth-reserve / preemption decision is arithmetically
    identical to a cache-less run - retention can never CAUSE a
    preemption. The physical reclaim happens lazily inside
    allocate/extend_to (`_ensure` -> `PrefixCache.reclaim`), invisible
    to the scheduler."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 0 or block_size < 1:
            raise ValueError(f"bad ledger shape: {num_blocks}x{block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._held: dict[int, int] = {}          # sid -> blocks held
        self._used = 0                           # owned blocks only
        self.peak_used = 0
        self._cache = None                       # bound PrefixCache
        self._shared: dict[int, int] = {}        # sid -> shared prefix blocks
        self._shared_used = 0                    # distinct active cached blocks
        self._retained = 0                       # cached blocks, refs == 0

    def bind_cache(self, cache) -> None:
        if self._cache is not None:
            raise ValueError("ledger already has a prefix cache bound")
        self._cache = cache

    @property
    def used_blocks(self) -> int:
        return self._used

    @property
    def shared_blocks(self) -> int:
        return self._shared_used

    @property
    def retained_blocks(self) -> int:
        return self._retained

    @property
    def free_blocks(self) -> int:
        """Schedulable blocks: physical free + retained (reclaimable)."""
        return self.num_blocks - self._used - self._shared_used

    @property
    def physical_free(self) -> int:
        return self.num_blocks - self._used - self._shared_used - self._retained

    def blocks_needed(self, tokens: int) -> int:
        return blocks_for(tokens, self.block_size)

    def can_admit(self, tokens: int) -> bool:
        return self.blocks_needed(tokens) <= self.free_blocks

    def held(self, sid: int) -> int:
        return self._held.get(sid, 0)

    def _ensure(self, need: int) -> None:
        """Make `need` blocks PHYSICALLY free, shedding retained cache
        blocks if the free list alone cannot cover it. Only reachable
        with a cache bound - without one, retained is always 0 and the
        `free_blocks` check above already guaranteed the space."""
        gap = need - self.physical_free
        if gap > 0:
            self._cache.reclaim(gap)

    def allocate(self, sid: int, tokens: int) -> None:
        """Allocate `tokens` of fresh KV for `sid`. A sequence admitted
        through a prefix match (`note_shared` already called) allocates
        only its UNMATCHED tokens here; `held()` reports shared + owned
        so growth math downstream needs no special case."""
        if sid in self._held:
            raise ValueError(f"seq {sid} already allocated")
        need = self.blocks_needed(tokens)
        if need > self.free_blocks:
            raise OutOfBlocks(f"need {need} blocks, {self.free_blocks} free")
        self._ensure(need)
        self._held[sid] = self._shared.get(sid, 0) + need
        self._used += need
        self.peak_used = max(self.peak_used, self._used)

    def extend_to(self, sid: int, tokens: int) -> None:
        """Grow seq `sid`'s allocation to cover `tokens` total."""
        have = self._held[sid]
        need = self.blocks_needed(tokens) - have
        if need <= 0:
            return
        if need > self.free_blocks:
            raise OutOfBlocks(f"extend needs {need} blocks, "
                              f"{self.free_blocks} free")
        self._ensure(need)
        self._held[sid] = have + need
        self._used += need
        self.peak_used = max(self.peak_used, self._used)

    def free(self, sid: int) -> None:
        # shared blocks return to the cache (their refs drop separately
        # via PrefixCache.release); blocks donated to the cache at
        # publish were already moved out of `_used` by cache_retain_from
        self._used -= self._held.pop(sid) - self._shared.pop(sid, 0)

    # ---------------------------------------------- PrefixCache accounting
    # Called only by the bound cache; each moves ONE block (or records a
    # seq's shared count) between the four populations above.
    def note_shared(self, sid: int, nblocks: int) -> None:
        """Seq `sid`'s first `nblocks` blocks live in the cache."""
        if sid in self._held or sid in self._shared:
            raise ValueError(f"seq {sid} already tracked")
        self._shared[sid] = nblocks

    def cache_activate(self) -> None:
        """A retained block gained its first reference."""
        self._retained -= 1
        self._shared_used += 1

    def cache_deactivate(self) -> None:
        """An active cached block lost its last reference."""
        self._shared_used -= 1
        self._retained += 1

    def cache_retain_from(self, sid: int) -> None:
        """Publish: one of `sid`'s owned blocks becomes cache-retained."""
        self._held[sid] -= 1
        self._used -= 1
        self._retained += 1

    def cache_evict(self) -> None:
        """A retained block was evicted - physically free again."""
        self._retained -= 1


# ---------------------------------------------------------------------------
# Scheduler state
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SchedSeq:
    """One request as the scheduler sees it (executor payload attached)."""

    sid: int
    prompt_len: int
    output_len: int
    payload: object = None
    # SLO-class priority (0 = most latency-critical; workload.py maps
    # class names to levels). Orders admission, decode-slot composition,
    # and preemption; equal priorities reproduce the pre-class schedule.
    priority: int = 1
    # prefill progress: `prefill_target` tokens must be (re)computed before
    # the sequence decodes; after a preemption it covers prompt + the
    # already-emitted prefix (vLLM recompute semantics)
    prefill_target: int = -1
    prefilled: int = 0
    emitted: int = 0
    kv: int = 0                       # tokens currently cached (pool length)
    preemptions: int = 0
    # scheduler bookkeeping (assigned by submit): submission order for
    # deterministic ties, and the step the seq entered the waiting queue
    # (aging credit - preserved across preemptions, so a preempted seq
    # keeps its seniority)
    order: int = 0
    enqueue_step: int = 0
    # chained content keys of the prompt's full KV blocks (empty when the
    # executor runs without a prefix cache) - serving/prefix_cache.py
    prefix_keys: tuple = ()
    # absolute finish deadline (None = unbounded). A relaxed-class seq
    # with a deadline is a run-anytime-before-T job: the waiting queue
    # orders it earliest-deadline-first WITHIN its class, and the
    # executors time it out at the first scheduling point past it.
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.prefill_target < 0:
            self.prefill_target = self.prompt_len

    @property
    def remaining(self) -> int:
        return self.output_len - self.emitted

    @property
    def ctx(self) -> int:
        """Decode-pricing context (matches the legacy `_Active.ctx`
        convention: prompt plus every token emitted so far)."""
        return self.prompt_len + self.emitted


@dataclasses.dataclass
class PrefillChunk:
    seq: SchedSeq
    tokens: int
    ctx_before: int                   # cached tokens the chunk attends to
    completes: bool                   # last chunk of this (re)prefill


@dataclasses.dataclass
class StepPlan:
    """One engine iteration's worth of work, in execution order."""

    chunks: list[PrefillChunk]
    decodes: list[SchedSeq]
    preempted: list[SchedSeq]

    def chunk_specs(self) -> tuple[tuple[int, int], ...]:
        return tuple((c.tokens, c.ctx_before) for c in self.chunks)

    def decode_ctxs(self) -> tuple[int, ...]:
        return tuple(s.ctx for s in self.decodes)


class ContinuousScheduler:
    """Builds hybrid `StepPlan`s under the token budget and block ledger.

    Deterministic: plans depend only on the submission order and the
    reported per-step emissions, never on wall time or randomness, so the
    simulator and the engine replay identical schedules.

    Contract per step: call `next_plan()`, execute/price it, then report
    outcomes in plan order - `complete_chunk` for every chunk (then
    `note_first_token` when a prefill just completed with nothing emitted
    yet), `note_decode(seq, emitted)` for every decode participant.
    Finished sequences free their blocks inside those callbacks.
    """

    def __init__(self, policy: BatchPolicy, max_batch: int,
                 ledger: BlockLedger, decode_tokens: int = 1,
                 mix_decode: bool = True,
                 cache: "Optional[PrefixCache]" = None):
        if policy.kind != "continuous":
            raise ValueError("ContinuousScheduler needs a continuous policy")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {max_batch}")
        self.policy = policy
        self.max_batch = max_batch
        self.ledger = ledger
        # cross-request prefix cache (None = off). All cache decisions -
        # match, acquire, publish, release - happen HERE, never in
        # executor code, so both executors replay identical reuse.
        self.cache = cache
        # mix_decode=True (standalone/dpd): every step is a true hybrid
        # forward - decode tokens + prefill chunks share one weight read.
        # mix_decode=False (spec/dsd): a "decode slot" is a whole
        # speculative round (a multi-pass draft+verify pipeline), so
        # riding chunks on it would gate TTFT behind the round's draft
        # steps; instead prefill chunks get dedicated budget-bounded
        # batched steps with priority, and rounds run when no prefill is
        # schedulable - decode stalls stay bounded by `token_budget`.
        self.mix_decode = mix_decode
        # worst-case KV growth of one decode participant per step (k+1 for
        # speculative kinds: the verify pass extends the cache by k+1
        # before rejected tokens are trimmed back)
        self.decode_tokens = max(decode_tokens, 1)
        self.waiting: list[SchedSeq] = []         # not yet holding blocks
        self.prefilling: list[SchedSeq] = []      # blocks held, chunks pending
        self.running: list[SchedSeq] = []         # fully prefilled, decoding
        self.finished: list[SchedSeq] = []
        self.aborted: list[SchedSeq] = []         # cancelled/timed-out/killed
        self._step = 0                            # next_plan() invocations
        self._order = 0                           # submission counter

    # ------------------------------------------------------------- intake
    def submit(self, seq: SchedSeq) -> SchedSeq:
        seq.order = self._order
        self._order += 1
        seq.enqueue_step = self._step
        self.waiting.append(seq)
        return seq

    def _eff_priority(self, seq: SchedSeq) -> int:
        """Waiting-queue priority with aging: one level of promotion per
        `age_steps` scheduler steps spent waiting (floor 0), so lower
        classes cannot starve behind an endless higher-class stream."""
        return aged_priority(seq.priority, self._step - seq.enqueue_step,
                             self.policy.age_steps)

    def _wkey(self, seq: SchedSeq) -> tuple[int, float, int]:
        """Waiting-queue order: class (aged), then earliest deadline WITHIN
        the class (EDF for run-anytime-before-T jobs), then submission
        order. Deadline-free workloads sort (p, inf, order) - identical to
        the pre-deadline (p, order) schedule, bit-exact by construction."""
        d = seq.deadline_s if seq.deadline_s is not None else math.inf
        return (self._eff_priority(seq), d, seq.order)

    @property
    def n_scheduled(self) -> int:
        return len(self.prefilling) + len(self.running)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running)

    # ------------------------------------------------------------ planning
    def _growth_reserve(self, decodes: list[SchedSeq]) -> int:
        """Worst-case blocks this step's decodes may pull from the pool."""
        return sum(
            growth_blocks(s.kv, self.decode_tokens,
                          self.ledger.held(s.sid), self.ledger.block_size)
            for s in decodes)

    def _preempt(self, seq: SchedSeq) -> None:
        if self.cache is not None:
            self.cache.release(seq.sid)      # drop shared-prefix refs
        self.ledger.free(seq.sid)
        if seq in self.running:
            self.running.remove(seq)
        else:
            self.prefilling.remove(seq)
        seq.preemptions += 1
        seq.prefill_target = recompute_target(seq.prompt_len, seq.emitted)
        seq.prefilled = 0
        seq.kv = 0
        # `order` keeps its original value (the seq still sorts ahead of
        # later same-class arrivals, the list equivalent of the old
        # appendleft re-queue), but aging credit RESETS: an aged victim
        # that still out-sorted its preemptor would be re-admitted in the
        # very step it was evicted for, churning forever
        seq.enqueue_step = self._step
        self.waiting.append(seq)

    def _select_decodes(self) -> list[SchedSeq]:
        """This step's decode participants: every running sequence when
        they all fit the token budget (the common case, identical to the
        pre-class scheduler); under slot pressure the slots go to the
        highest classes first and shortest-remaining-first within a
        class. Plan order stays running-list (admission) order either
        way, so executor-side iteration (and rng draws) are stable."""
        slots = decode_slot_count(self.policy.token_budget, self.decode_tokens)
        if len(self.running) <= slots:
            return list(self.running)
        chosen = {id(s) for s in sorted(
            self.running,
            key=lambda s: (s.priority, s.remaining, s.order))[:slots]}
        return [s for s in self.running if id(s) in chosen]

    def _pick_victim(self, decodes: list[SchedSeq],
                     max_priority: Optional[int] = None,
                     ) -> Optional[SchedSeq]:
        """Class-ordered preemption victim among the block holders.

        Worst (highest-value) class first - a tight sequence is never
        evicted while a relaxed one holds blocks - and within a class the
        least-sunk work first: partial prefills (pure recompute), then
        running sequences NOT decoding this step (SRF-deferred: evicting
        them does not shrink the step), then active decodes, youngest
        first. The last active decode is only evictable for a strictly
        better class - a partial prefill during growth eviction, or the
        pending class (`max_priority`) during admission eviction;
        otherwise the step must keep its one decode and `OutOfBlocks`
        can surface.

        `max_priority` restricts victims to classes strictly worse than
        it (admission preemption must never evict an equal-or-better
        class)."""
        in_decodes = {id(s) for s in decodes}
        cands = [(s, 0) for s in self.prefilling]
        cands += [(s, 1) for s in self.running if id(s) not in in_decodes]
        if len(decodes) > 1:
            cands += [(s, 2) for s in decodes]
        elif decodes and (
                any(p.priority < decodes[0].priority for p in self.prefilling)
                or (max_priority is not None
                    and decodes[0].priority > max_priority)):
            cands += [(s, 2) for s in decodes]
        if max_priority is not None:
            cands = [(s, r) for s, r in cands if s.priority > max_priority]
        if not cands:
            return None
        return max(cands, key=lambda c: (c[0].priority, -c[1], c[0].order))[0]

    def _queue_head(self) -> Optional[SchedSeq]:
        """The sequence admission would take next: the first prefilling
        seq with chunks still pending (head-of-line continue), else the
        sorted-waiting head."""
        for s in self.prefilling:
            if s.prefilled < s.prefill_target:
                return s
        if self.waiting:
            self.waiting.sort(key=self._wkey)
            return self.waiting[0]
        return None

    def _build_chunks(self, budget: int, reserve: int,
                      skip: "frozenset[int] | set[int]" = frozenset(),
                      decodes: "list[SchedSeq] | tuple" = (),
                      ) -> list[PrefillChunk]:
        """Admit/continue prefill chunks into `budget` tokens, leaving
        `reserve` blocks untouched for the running decodes' growth.

        `skip` bars sids from re-admission: a victim preempted earlier in
        the SAME step must not take back the blocks it was evicted to
        free (a small victim re-admitting while the head stays blocked
        repeats every step and never converges). A skipped victim still
        blocks the line behind it - letting later (worse-class) arrivals
        overtake it would admit a relaxed seq in the very step a better
        one was evicted.

        `decodes` are this step's decode participants (mix_decode steps):
        when the policy's `tpot_guard_frac` < 1 and the step carries a
        decode of some class, chunk tokens from STRICTLY BETTER classes
        are capped at that fraction of the token budget - chunked prefill
        makes the step longer, and the step time IS the TPOT of every
        decode riding it, so an unbounded tight chunk stream would
        stretch a relaxed decode's TPOT without limit. A guarded seq
        stalls (no overtaking by worse classes - that would not shorten
        the step) until the decode mix drains."""
        chunks: list[PrefillChunk] = []
        guard_cap = None
        worst_decode = -1
        if decodes and self.policy.tpot_guard_frac < 1.0:
            worst_decode = max(s.priority for s in decodes)
            guard_cap = guard_cap_tokens(self.policy.tpot_guard_frac,
                                         self.policy.token_budget)
        guarded_used = 0

        def guard_room(seq: SchedSeq) -> int:
            """Chunk tokens the TPOT guard still allows this seq."""
            if guard_cap is None or seq.priority >= worst_decode:
                return self.policy.token_budget     # unguarded
            return guard_cap - guarded_used

        # in-flight prefills continue first (admission order), one chunk
        # per seq/step
        for seq in self.prefilling:
            if budget <= 0:
                break
            take = chunk_take(self.policy.chunk_tokens, seq.prefill_target,
                              seq.prefilled, budget, guard_room(seq))
            if take <= 0:
                continue
            need = (self.ledger.blocks_needed(seq.prefilled + take)
                    - self.ledger.held(seq.sid))
            if need > self.ledger.free_blocks - reserve:
                break                              # head-of-line, no skipping
            self.ledger.extend_to(seq.sid, seq.prefilled + take)
            chunks.append(PrefillChunk(seq, take, seq.prefilled,
                                       seq.prefilled + take >= seq.prefill_target))
            budget -= take
            if guard_cap is not None and seq.priority < worst_decode:
                guarded_used += take
        # then admit fresh sequences in effective-priority order (aged
        # classes promote; within a class, submission order) while budget
        # and blocks allow
        self.waiting.sort(key=self._wkey)
        while (budget > 0 and self.waiting
               and self.n_scheduled < self.max_batch):
            seq = self.waiting[0]
            if seq.sid in skip:
                break                              # this-step victim blocks
            # longest cached prefix of the prompt, block-aligned and
            # capped below the full prompt: the LAST prompt token must
            # be computed (its logits sample the first output token).
            # Matched tokens never enter a chunk - they are priced as
            # cached context, not prefill (perfmodel.hybrid_step_cost)
            if guard_room(seq) <= 0:
                break                     # guard-capped head stalls the line
            hit = fresh = 0
            if self.cache is not None and seq.prefix_keys:
                hit = self.cache.match_blocks(
                    seq.prefix_keys,
                    (seq.prompt_len - 1) // self.policy.block_size)
                # pinning retained nodes consumes schedulable-free blocks
                fresh = self.cache.fresh_cost(seq.prefix_keys, hit)
            start = hit * self.policy.block_size
            take = chunk_take(self.policy.chunk_tokens, seq.prefill_target,
                              start, budget, guard_room(seq))
            need = self.ledger.blocks_needed(take)
            if need + fresh > self.ledger.free_blocks - reserve:
                break                              # priority order: no overtaking
            self.waiting.pop(0)
            if hit:
                self.cache.acquire(seq.sid, seq.prefix_keys, hit)
                seq.prefilled = start
                seq.kv = start
            self.ledger.allocate(seq.sid, take)
            self.prefilling.append(seq)
            chunks.append(PrefillChunk(seq, take, seq.prefilled,
                                       seq.prefilled + take >= seq.prefill_target))
            budget -= take
            if guard_cap is not None and seq.priority < worst_decode:
                guarded_used += take
        return chunks

    def _admission_preempt(self, decodes: list[SchedSeq],
                           preempted: list[SchedSeq],
                           budget_of) -> list[PrefillChunk]:
        """No chunk fit: evict block holders of strictly worse RAW class
        than the QUEUE HEAD (class-ordered) until it admits, so a full
        relaxed decode pool cannot gate a tight TTFT behind whole relaxed
        generations - and admission can always make progress by
        preemption when a better class heads the queue.

        Two deliberate restrictions keep this churn-free: the comparison
        is raw-vs-raw (aging promotes queue ORDER, never preemption
        power - an aged standard seq evicting a standard holder would
        churn a single-class workload forever), and the beneficiary is
        the actual queue head (evicting on behalf of a better class
        buried behind an aged head would free blocks the head, not the
        better class, then consumes - the same churn one level up)."""
        chunks: list[PrefillChunk] = []
        while not chunks:
            head = self._queue_head()
            if head is None:
                return chunks
            # futility check: do not throw away worse-class KV when even
            # reclaiming ALL of it cannot fit the head's next chunk (the
            # blocks freed would sit next to same-class holders the head
            # may not evict, for zero admission progress)
            budget = budget_of(decodes)
            if budget <= 0:
                return chunks
            take = chunk_take(self.policy.chunk_tokens, head.prefill_target,
                              head.prefilled, budget, self.policy.token_budget)
            need = (self.ledger.blocks_needed(head.prefilled + take)
                    - self.ledger.held(head.sid))
            reclaimable = sum(
                self.ledger.held(s.sid)
                for s in self.prefilling + self.running
                if s.priority > head.priority)
            # admission must also clear the growth reserve of the decodes
            # that would REMAIN (equal-or-better class - not evictable
            # for this head), so count it against the reclaimable blocks
            reserve_keep = self._growth_reserve(
                [s for s in decodes if s.priority <= head.priority])
            if need > self.ledger.free_blocks + reclaimable - reserve_keep:
                return chunks
            victim = self._pick_victim(decodes, max_priority=head.priority)
            if victim is None:
                return chunks
            self._preempt(victim)
            if victim in decodes:
                decodes.remove(victim)
            preempted.append(victim)
            chunks = self._build_chunks(budget_of(decodes),
                                        self._growth_reserve(decodes),
                                        skip={v.sid for v in preempted},
                                        decodes=decodes)
        return chunks

    def next_plan(self) -> Optional[StepPlan]:
        """The next step, or None when nothing is schedulable."""
        if not self.has_work:
            return None
        self._step += 1
        preempted: list[SchedSeq] = []
        if not self.mix_decode:
            # prefill-priority composition: chunks get dedicated steps
            chunks = self._build_chunks(self.policy.token_budget,
                                        self._growth_reserve(self.running))
            if not chunks:
                chunks = self._admission_preempt(
                    self.running, preempted,
                    lambda _d: self.policy.token_budget)
            if chunks:
                return StepPlan(chunks, [], preempted)
        decodes = self._select_decodes()
        # guarantee this step's worst-case decode growth fits: evict the
        # worst class first, least-sunk within a class (partial prefills -
        # pure recompute, no emitted tokens lost - then deferred, then the
        # youngest active decodes)
        while self._growth_reserve(decodes) > self.ledger.free_blocks:
            victim = self._pick_victim(decodes)
            if victim is None:
                break
            self._preempt(victim)
            if victim in decodes:
                decodes.remove(victim)
            preempted.append(victim)
        reserve = self._growth_reserve(decodes)
        if reserve > self.ledger.free_blocks:
            # a single sequence the pool cannot grow for even with the
            # rest evicted: re-prefill needs at least as many blocks
            raise OutOfBlocks(
                f"KV pool of {self.ledger.num_blocks} blocks cannot grow a "
                f"single sequence (kv={decodes[0].kv} "
                f"+{self.decode_tokens} tokens)")
        chunks = [] if not self.mix_decode else self._build_chunks(
            self.policy.token_budget - len(decodes), reserve,
            skip={v.sid for v in preempted}, decodes=decodes)
        if self.mix_decode and not chunks and decodes:
            chunks = self._admission_preempt(
                decodes, preempted,
                lambda d: self.policy.token_budget - len(d))
        if not chunks and not decodes:
            # nothing runs and no decode will free blocks. Partially
            # prefilled sequences behind the head-of-line may be wedging
            # the pool: preempt them class-ordered-youngest-first
            # (recompute) until the head can take a chunk
            while not chunks and len(self.prefilling) > 1:
                victim = max(self.prefilling,
                             key=lambda s: (s.priority, s.order))
                self._preempt(victim)
                preempted.append(victim)
                chunks = self._build_chunks(self.policy.token_budget, 0,
                                            skip={v.sid for v in preempted})
            if not chunks:
                if self.prefilling or self.waiting:
                    # the pool is smaller than one chunk of the
                    # head-of-line prefill: preemption cannot help
                    raise OutOfBlocks(
                        f"KV pool of {self.ledger.num_blocks} blocks cannot "
                        f"fit the next prefill chunk of any queued sequence")
                return None
        return StepPlan(chunks, decodes, preempted)

    # ----------------------------------------------------------- outcomes
    def complete_chunk(self, seq: SchedSeq, tokens: int) -> bool:
        """Record an executed chunk; True when the (re)prefill completed."""
        seq.prefilled += tokens
        seq.kv = seq.prefilled
        if seq.prefilled < seq.prefill_target:
            return False
        self.prefilling.remove(seq)
        self.running.append(seq)
        return True

    def note_first_token(self, seq: SchedSeq) -> bool:
        """First token sampled off the prefill logits; True when that
        already finishes the request (output_len == 1)."""
        seq.emitted = 1
        if seq.remaining <= 0:
            self._finish(seq)
            return True
        return False

    def note_decode(self, seq: SchedSeq, emitted: int) -> bool:
        """Record a decode participant's emissions; True when finished."""
        seq.emitted += emitted
        seq.kv += emitted
        self.ledger.extend_to(seq.sid, seq.kv)
        if seq.remaining <= 0:
            self._finish(seq)
            return True
        return False

    def abort(self, seq: SchedSeq) -> None:
        """Mid-flight abort (cancellation, timeout, replica kill): release
        whatever the sequence holds and drop it from the schedule.

        Unlike `_preempt` the seq is NOT re-queued and unlike `_finish` its
        prompt blocks are NOT published - a cancelled request's prefix was
        never served to completion, so retaining it would retain work the
        accounting already wrote off. Blocks and cache refs are freed
        through the same ledger/cache hooks as the preemption path, so the
        four-population conservation invariant holds after every abort."""
        if seq in self.waiting:
            self.waiting.remove(seq)       # holds no blocks, no cache refs
        else:
            if self.cache is not None:
                self.cache.release(seq.sid)
            self.ledger.free(seq.sid)
            if seq in self.running:
                self.running.remove(seq)
            else:
                self.prefilling.remove(seq)
        self.aborted.append(seq)

    def _finish(self, seq: SchedSeq) -> None:
        self.running.remove(seq)
        if self.cache is not None and seq.prefix_keys:
            # publish-on-finish: the prompt's blocks move into the cache
            # (carbon-capped) BEFORE the allocation is freed, so the
            # engine can pin the real pool blocks while they still exist
            self.cache.publish(seq.sid, seq.prefix_keys)
        elif self.cache is not None:
            self.cache.release(seq.sid)
        self.ledger.free(seq.sid)
        self.finished.append(seq)
