"""Real-compute serving engine (serialized or iteration-level batching).

Runs real PyTorch forward passes on the card (or, when the caller asks for
the CPU, the kernels' plain versions at reduced size) with scheduling over a
paged KV pool. A port of src/repro/serving/engine.py; the scheduling,
pricing, prefix-cache and fault/lifecycle logic are the reference's, line
for line.
Two scheduler policies (serving/batching.py), selected via `batching=`:

  serialized (legacy default)
  - prefill requests take priority (one whole prompt per iteration),
  - active sequences decode as one batch per iteration,
  - admission by batch count against the pool.

  continuous (vLLM/Sarathi-style)
  - the engine drives the SAME `ContinuousScheduler` object model as the
    cluster simulator (built by the shared factories in batching.py), so
    both executors make identical admission / chunking / preemption
    decisions and stay parity-comparable per step;
  - prefill runs in real *chunks* through `PagedKVPool`: each chunk step
    computes the prompt prefix so far and scatters its KV into the
    sequence's blocks (block-granular growth, exactly the ledger's
    arithmetic), decodes ride along under the step token budget;
  - every step is priced by `costs.hybrid_step_charges`, the same
    function the simulator charges.

In both policies spec/dsd modes run batched speculative rounds
(core/spec_decode.py) with *measured* acceptance rates, and every
iteration is priced by the analytic chip model, so a run yields (real
tokens, real acceptance, modeled latency/energy/carbon).

The engine is the ground-truth executor: the cluster simulator
(simulator.py) takes its measured acceptance rate and reproduces its
per-iteration timing model at scales the CPU cannot execute. The modelled
clock and carbon are the cost model's figures for the named chips
(`new_chip`/`old_chip` in core/carbon.py's CHIP_DB), not measurements of
the device the forwards run on.

Differences from the reference:
  - `device` (default: the card) holds the KV pools and the sampling
    generator, and the params must live there; without a CUDA device the
    engine raises unless the caller names the CPU.
  - The port's `ExecConfig.use_kernels` defaults to True, so paged="auto"
    takes the paged path and attention reaches the kernels on the card.
  - Sampling draws from a `torch.Generator` seeded with `seed`, not from
    `jax.random`; greedy (temperature 0) streams match the reference's.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.carbon import CHIP_DB
from repro_torch.core.spec_decode import SpecConfig, spec_decode_round
from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DEFAULT_EXEC, ExecConfig, serving_guard, torch_dtype
from repro_torch.serving.batching import (
    BatchPolicy,
    ContinuousScheduler,
    DpdReadyQueue,
    OutOfBlocks,
    SchedSeq,
    build_dpd_decode_ledger,
    build_dpd_prefill_scheduler,
    build_single_pool_scheduler,
    plan_dpd_decode_step,
    resolve_batch_policy,
)
from repro_torch.serving.costs import (
    dpd_kv_bytes,
    hybrid_step_charges,
    prefill_charges,
    spec_round_charges,
    spec_round_time,
)
from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import make_injector
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.perfmodel import Interconnect, decode_cost
from repro_torch.serving.prefix_cache import token_block_keys
from repro_torch.serving.simulator import ChipUse
from repro_torch.serving.workload import SLO_CLASSES, class_priority


@dataclasses.dataclass
class EngineRequest:
    req_id: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int
    arrival_s: float = 0.0
    slo_class: str = "standard"      # workload.SLO_CLASSES latency class
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    ttft_s: float = float("nan")
    first_token_s: float = float("nan")
    last_token_s: float = float("nan")
    # lifecycle bounds + outcome, mirroring workload.Request / ReqTrace:
    # "ok" (finished or pending), else "cancelled" / "timed_out" / "killed"
    deadline_s: Optional[float] = None
    cancel_at_s: Optional[float] = None
    status: str = "ok"

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens

    @property
    def tpot_s(self) -> float:
        n = len(self.out_tokens)
        return 0.0 if n <= 1 else (self.last_token_s - self.first_token_s) / (n - 1)


class ServingEngine:
    """kind: standalone | spec | dsd | dpd (pools are logical on CPU;
    placement only affects the timing/energy attribution)."""

    def __init__(
        self,
        target_cfg: ModelConfig,
        target_params,
        kind: str = "standalone",
        draft_cfg: Optional[ModelConfig] = None,
        draft_params=None,
        spec: SpecConfig = SpecConfig(),
        new_chip: str = "a100",
        old_chip: Optional[str] = None,
        interconnect: Interconnect = Interconnect(),
        max_batch: int = 8,
        pool_blocks: int = 512,
        block_size: int = 16,
        temperature: float = 1.0,
        seed: int = 0,
        exec_cfg: ExecConfig = DEFAULT_EXEC,
        batching: "BatchPolicy | str | None" = None,
        ci_trace=None,
        paged: "bool | str" = "auto",
        faults=None,
        device=None,
    ):
        if kind in ("spec", "dsd"):
            assert draft_cfg is not None and draft_params is not None
        self.policy = resolve_batch_policy(batching, default="serialized")
        if self.policy.kind == "continuous":
            # the REAL pool is the capacity: the scheduler's ledger must
            # never admit more blocks than the storage holds
            if self.policy.num_blocks is None:
                self.policy = dataclasses.replace(self.policy,
                                                  num_blocks=pool_blocks)
            elif self.policy.num_blocks > pool_blocks:
                raise ValueError(
                    f"BatchPolicy.num_blocks={self.policy.num_blocks} exceeds "
                    f"the physical pool ({pool_blocks} blocks): the scheduler "
                    f"would admit more KV than the storage holds")
            if self.policy.block_size != block_size:
                raise ValueError(
                    f"block_size={block_size} conflicts with "
                    f"BatchPolicy.block_size={self.policy.block_size}; set "
                    f"the block size on the policy for continuous batching")
        self.cfg = target_cfg
        self.params = target_params
        self.kind = kind
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.spec = dataclasses.replace(spec, temperature=temperature)
        self.exec_cfg = exec_cfg
        self.temperature = temperature
        self.max_batch = max_batch
        self.new_chip = CHIP_DB[new_chip]
        self.old_chip = CHIP_DB[old_chip] if old_chip else None
        self.interconnect = interconnect

        # paged (gather-free) hot path: decode steps read the pool's page
        # arrays through block tables (kernels/paged_attention.py) instead
        # of gathering each sequence contiguous first, and chunked prefill
        # runs incrementally against the paged context. Spec rounds keep
        # the gather path (the extend/rollback contract needs a contiguous
        # window); recurrent/vlm families have no paged attention.
        # paged="auto" follows exec_cfg.use_kernels; True/False force it.
        fam_ok = (target_cfg.family in ("dense", "moe")
                  and target_cfg.attn is not None
                  and target_cfg.attn.m_rope_sections is None)
        if paged == "auto":
            self.paged = bool(exec_cfg.use_kernels) and fam_ok
        else:
            self.paged = bool(paged)
            if self.paged and not fam_ok:
                raise ValueError(
                    f"paged attention unsupported for family="
                    f"{target_cfg.family!r} (needs dense/moe, no m-rope)")

        self.device = resolve_device(device)
        for name, p in (("target_params", target_params),
                        ("draft_params", draft_params)):
            if p is not None and p["tok"]["embed"].device != self.device:
                raise ValueError(f"{name} live on {p['tok']['embed'].device}, "
                                 f"the engine on {self.device}")
            if p is not None:
                serving_guard(p["final_norm"], exec_cfg, "ServingEngine")
        self.pool = PagedKVPool(target_cfg, pool_blocks, block_size,
                                dtype=torch_dtype(target_cfg), device=self.device)
        self.draft_pool = (
            PagedKVPool(draft_cfg, pool_blocks, block_size,
                        dtype=torch_dtype(draft_cfg), device=self.device)
            if draft_cfg else None
        )
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.clock = 0.0                      # modeled time
        self.use = {self.new_chip.name: ChipUse()}
        if self.old_chip:
            self.use.setdefault(self.old_chip.name, ChipUse())
        self.link_bytes = 0.0

        self.waiting: deque[EngineRequest] = deque()
        self.active: dict[int, EngineRequest] = {}
        self.last_token: dict[int, int] = {}  # committed-but-unprocessed token
        self.finished: list[EngineRequest] = []
        self.aborted: list[EngineRequest] = []  # cancelled/timed_out/killed
        self._next_id = 0
        # measured speculative statistics
        self.rounds = 0
        self.accepted = 0
        self.proposed = 0
        # continuous-policy state: the SAME scheduler construction as the
        # simulator's (batching.py factories), so both executors replay
        # identical schedules on identical workloads
        self._sched: Optional[ContinuousScheduler] = None
        self._sched_a: Optional[ContinuousScheduler] = None  # dpd pool A
        self._ledger_b = None                                # dpd pool B
        self._decoding_b: list[SchedSeq] = []                # dpd decode set
        # dpd pool-B admission line across the KV link: class-aware
        # (tight > standard > relaxed) with aging, shared with the
        # simulator's continuous path (batching.DpdReadyQueue)
        self._ready_b = DpdReadyQueue(self.policy.age_steps)
        # tokens of ADOPTED (cache-shared) prefix per sid: KV the sequence
        # aliases but must never rewrite (prefix_cache sharing)
        self._shared_tok: dict[int, int] = {}
        # fault state, constructed exactly like the simulator's so both
        # executors share one injector rng stream per (seed, trace)
        self._fault = make_injector(faults, seed=seed)
        self._kill_s = self._fault.kill_s if self._fault else float("inf")
        self.dead = False
        self.dead_s: Optional[float] = None
        self._lifecycle = False           # any deadline/cancel submitted
        if self.policy.kind == "continuous":
            if kind == "dpd":
                self._sched_a = build_dpd_prefill_scheduler(
                    self.policy, max_batch, target_cfg, self.new_chip,
                    ci_trace=ci_trace)
                # the two ledgers model the two CHIPS' HBM; on the engine
                # both logical pools share ONE physical PagedKVPool, so cap
                # pool A's (chip-derived, effectively unbounded for reduced
                # configs) ledger at the storage. Joint A+B pressure beyond
                # the physical pool still raises kv_cache.OutOfBlocks - the
                # same undersized-pool signal the serialized engine gives
                self._sched_a.ledger.num_blocks = min(
                    self._sched_a.ledger.num_blocks, pool_blocks)
                self._ledger_b = build_dpd_decode_ledger(
                    self.policy, target_cfg, self.old_chip)
            else:
                self._sched = build_single_pool_scheduler(
                    self.policy, kind, max_batch, spec.num_draft_tokens,
                    target_cfg, draft_cfg, self.new_chip, ci_trace=ci_trace)
            # the engine realizes cache decisions PHYSICALLY: published
            # nodes pin real pool blocks (target + draft), eviction
            # releases them. The scheduler stays the only decision-maker.
            sched = self._sched or self._sched_a
            if sched.cache is not None:
                sched.cache.grab_fn = self._cache_grab
                sched.cache.drop_fn = self._cache_drop

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, arrival_s: float = 0.0,
               slo_class: str = "standard",
               deadline_s: Optional[float] = None,
               cancel_at_s: Optional[float] = None) -> EngineRequest:
        if slo_class not in SLO_CLASSES:
            raise ValueError(f"unknown slo_class: {slo_class!r} "
                             f"(one of {sorted(SLO_CLASSES)})")
        if deadline_s is not None and deadline_s <= arrival_s:
            raise ValueError(f"deadline_s {deadline_s} must exceed arrival_s")
        if cancel_at_s is not None and cancel_at_s < arrival_s:
            raise ValueError(f"cancel_at_s {cancel_at_s} precedes arrival_s")
        r = EngineRequest(self._next_id, np.asarray(prompt, np.int32),
                          max_new_tokens, arrival_s, slo_class=slo_class,
                          deadline_s=deadline_s, cancel_at_s=cancel_at_s)
        if deadline_s is not None or cancel_at_s is not None:
            self._lifecycle = True
        self._next_id += 1
        self.waiting.append(r)
        return r

    def _charge(self, chip, cost, at_s: Optional[float] = None):
        # records (start, end, energy) segments like the simulator, so
        # engine runs can also be priced against a CarbonTrace timeline
        self.use[chip.name].add(self.clock if at_s is None else at_s, cost)
        return cost.time_s

    # ------------------------------------------------- lifecycle / faults
    @staticmethod
    def _expired(r: EngineRequest, t: float) -> Optional[str]:
        """Abort reason for an unfinished request at scheduling point `t`
        (cancellation wins ties - same rule as ReplicaSim._expired)."""
        if r.cancel_at_s is not None and r.cancel_at_s <= t:
            return "cancelled"
        if r.deadline_s is not None and r.deadline_s <= t:
            return "timed_out"
        return None

    def _dilate(self, begin_s: float, base_s: float) -> float:
        """Wall-clock duration of a compute step beginning at `begin_s`:
        the one stall code path (FaultInjector.step_time). Identity
        without an injector. Charges are never dilated - a stalled chip
        waits, it does not re-compute - and dpd link transfers keep their
        base time (the interconnect is not the straggling device)."""
        if self._fault is None:
            return base_s
        return self._fault.step_time(begin_s, base_s)

    def _abort_cleanup(self, sid: int) -> None:
        """Release everything the engine itself holds for an aborted
        sequence: tracking dicts and the REAL pool blocks. Scheduler-side
        state (ledger blocks, cache refs) is released by the caller
        through `ContinuousScheduler.abort` / `_ledger_b.free` first -
        this is the physical mirror, like `_retire_continuous` without
        the finish bookkeeping."""
        self.active.pop(sid, None)
        self.last_token.pop(sid, None)
        self._shared_tok.pop(sid, None)
        if self.pool.has(sid):
            self.pool.free(sid)
        if self.draft_pool is not None and self.draft_pool.has(sid):
            self.draft_pool.free(sid)

    def kill(self, at_s: float) -> None:
        """The engine dies NOW: mirror of `ReplicaSim.kill`. Every
        unfinished request is aborted with status "killed", scheduler
        ledgers are freed, retained prefix-cache nodes are shed (their
        pinned pool blocks deref through the drop hook), the physical
        pools release every live sequence, and all queues empty. Charges
        already written stay written - partial work is charged exactly
        once."""
        if self.dead:
            return
        self.dead = True
        self.dead_s = at_s
        self.clock = max(self.clock, at_s)
        victims = list(self.active.values()) + list(self.waiting)
        if self.policy.kind == "continuous":
            sched = self._sched_a if self.kind == "dpd" else self._sched
            if sched is not None:
                for seq in (list(sched.running) + list(sched.prefilling)
                            + list(sched.waiting)):
                    sched.abort(seq)
                if sched.cache is not None:
                    sched.cache.shed()
            if self.kind == "dpd":
                for seq in self._decoding_b:
                    self._ledger_b.free(seq.sid)
                self._decoding_b.clear()
                self._ready_b.purge(lambda item: True)
        for r in victims:
            self._abort_cleanup(r.req_id)
            if not r.done and r.status == "ok":
                r.status = "killed"
                self.aborted.append(r)
        self.waiting.clear()

    def _abort(self, r: EngineRequest, status: str) -> None:
        """One aborted (cancelled / timed-out) request: engine-side
        cleanup + outcome bookkeeping. Scheduler/ledger state must
        already be released by the caller."""
        r.status = status
        self._abort_cleanup(r.req_id)
        self.aborted.append(r)

    def status_counts(self) -> dict[str, int]:
        """Requests per lifecycle outcome over everything submitted -
        the engine-side twin of SimResult.status_counts (every request
        exactly once)."""
        out = {"ok": 0, "cancelled": 0, "timed_out": 0, "killed": 0}
        for r in self.finished:
            out[r.status] += 1
        for r in self.aborted:
            out[r.status] += 1
        for r in self.active.values():
            out[r.status] += 1
        for r in self.waiting:
            out[r.status] += 1
        return out

    def _ints(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """(B, V) logits -> (B,) int32 tokens on the host."""
        if self.temperature <= 0:
            tok = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits.float() / self.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        return tok.to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration. Returns False when fully idle.

        Arrival-aware (same admission as the simulator's loop): a waiting
        request takes prefill priority once it has arrived; future
        arrivals only pull the clock forward when the engine is otherwise
        idle - decode never gets clock-warped past pending work.

        Fault semantics mirror `ReplicaSim.advance_to`: every iteration
        that *begins* before the scripted kill time runs to completion
        and stays charged (non-preemptive), then `kill()` fires and
        step() returns False for good."""
        if self.dead:
            return False
        if self.policy.kind == "continuous":
            if self.kind == "dpd":
                return self._step_continuous_dpd()
            return self._step_continuous()
        return self._step_serialized()

    def _step_serialized(self) -> bool:
        while True:
            if self._lifecycle:
                now = self.clock
                for r in [r for r in self.waiting
                          if r.arrival_s <= now and self._expired(r, now)]:
                    self.waiting.remove(r)
                    self._abort(r, self._expired(r, now))
                for r in [r for r in self.active.values()
                          if self._expired(r, now)]:
                    self._abort(r, self._expired(r, now))
            want_prefill = bool(
                self.waiting and len(self.active) < self.max_batch
                and (self.waiting[0].arrival_s <= self.clock
                     or not self.active))
            if not want_prefill and not self.active:
                if self._kill_s < float("inf"):
                    self.kill(self._kill_s)
                return False
            begin = self.clock
            if want_prefill:
                begin = max(begin, self.waiting[0].arrival_s)
            if begin >= self._kill_s:
                self.kill(self._kill_s)
                return False
            if want_prefill:
                if self._lifecycle and begin > self.clock:
                    # idle jump: rescan expiry at the jumped instant
                    # before prefilling (the simulator's loop-top order)
                    self.clock = begin
                    continue
                self._do_prefill(self.waiting.popleft())
                return True
            if self.kind in ("spec", "dsd"):
                self._do_spec_round()
            else:
                self._do_decode_step()
            return True

    def run_until_idle(self, max_iters: int = 100_000) -> list[EngineRequest]:
        for _ in range(max_iters):
            if not self.step():
                break
        return self.finished

    # ------------------------------------------------------------------
    def _do_prefill(self, r: EngineRequest) -> None:
        self.clock = max(self.clock, r.arrival_s)
        pl = len(r.prompt)
        batch = {"tokens": torch.from_numpy(r.prompt).to(self.device)[None, :]}
        logits, cache = backbone.prefill(self.params, batch, self.cfg, self.exec_cfg)
        self.pool.allocate(r.req_id, pl)
        self.pool.scatter([r.req_id], cache["k"], cache["v"])
        if self.kind in ("spec", "dsd"):
            _, dcache = backbone.prefill(self.draft_params, batch, self.draft_cfg, self.exec_cfg)
            self.draft_pool.allocate(r.req_id, pl)
            self.draft_pool.scatter([r.req_id], dcache["k"], dcache["v"])

        # pricing: the shared cost schedule (costs.py), identical to the
        # cluster simulator's prefill admission
        sched = prefill_charges(self.kind, self.cfg, self.draft_cfg,
                                self.new_chip, self.old_chip, pl)
        for chip_name, cost, rel_s in sched.charges:
            self._charge(CHIP_DB[chip_name], cost, at_s=self.clock + rel_s)
        dur = self._dilate(self.clock, sched.duration_s)
        if self.kind == "dpd":
            # KV + recurrent state cross to the decode pool
            nbytes = dpd_kv_bytes(self.cfg, pl)
            self.link_bytes += nbytes
            dur += self.interconnect.transfer_time(nbytes)

        self.clock += dur
        tok = int(self._sample(logits)[0])
        r.out_tokens.append(tok)
        r.ttft_s = self.clock - r.arrival_s
        r.first_token_s = r.last_token_s = self.clock
        if r.done:
            self._finish(r)
        else:
            self.active[r.req_id] = r
            self.last_token[r.req_id] = tok

    def _gather(self, pool: PagedKVPool, sids: list[int], extra: int):
        for sid in sids:
            pool.extend(sid, extra)
        max_len = max(pool.seq(sid).length for sid in sids)
        k, v = pool.gather(sids, max_len)
        pos = self._ints([pool.seq(sid).length - extra for sid in sids])
        return {"k": k, "v": v, "pos": pos}

    def _commit(self, pool: PagedKVPool, sids: list[int], cache, lengths) -> None:
        pool.scatter(sids, cache["k"], cache["v"])
        for sid, ln in zip(sids, lengths):
            pool.seq(sid).length = int(ln)

    def _decode_logits(self, pool: PagedKVPool, sids: list[int],
                       tokens: torch.Tensor) -> torch.Tensor:
        """One batched decode forward, advancing each sequence by 1.

        Paged: hand the pool's page arrays + block tables straight to
        `serve_step_paged` and `scatter_append` only the new token - no
        gather, no full-cache scatter. Dense: gather each sequence
        contiguous, run `serve_step`, scatter the whole cache back. On
        CPU both produce bit-identical logits (the paged plain version
        mirrors the dense math op-for-op - kernels/paged_attention.py)."""
        if self.paged:
            old = [pool.seq(s).length for s in sids]
            for s in sids:
                pool.extend(s, 1)
            max_len = max(old) + 1
            tables = pool.device_tables(sids, pool.blocks_needed(max_len))
            logits, kt, vt = backbone.serve_step_paged(
                self.params, pool.k, pool.v, tables,
                self._ints(old), tokens, self.cfg,
                self.exec_cfg, max_len=max_len)
            pool.scatter_append(sids, kt, vt, old)
            return logits
        cache = self._gather(pool, sids, 1)
        logits, cache = backbone.serve_step(self.params, cache, tokens,
                                            self.cfg, self.exec_cfg)
        self._commit(pool, sids, cache, cache["pos"].cpu().numpy())
        return logits

    def _do_decode_step(self) -> None:
        sids = sorted(self.active)
        tokens = self._ints([self.last_token[s] for s in sids])
        logits = self._decode_logits(self.pool, sids, tokens)
        new = self._sample(logits)
        ctx = int(np.mean([self.pool.seq(s).length for s in sids]))
        chip = self.old_chip if self.kind == "dpd" else self.new_chip
        self.clock += self._dilate(
            self.clock,
            self._charge(chip, decode_cost(self.cfg, chip, len(sids), ctx)))
        for sid, tok in zip(sids, new):
            self._emit(self.active[sid], [int(tok)])
            self.last_token[sid] = int(tok)
        self._reap()

    def _do_spec_round(self) -> None:
        k = self.spec.num_draft_tokens
        sids = sorted(self.active)
        b = len(sids)
        tcache = self._gather(self.pool, sids, k + 1)
        dcache = self._gather(self.draft_pool, sids, k + 1)
        last = self._ints([self.last_token[s] for s in sids])
        out = spec_decode_round(
            self.params, self.cfg, tcache,
            self.draft_params, self.draft_cfg, dcache,
            last, self.spec, self.gen, self.exec_cfg)
        n_acc = out["n_accepted"].cpu().numpy()
        self._commit(self.pool, sids, out["target_cache"], out["target_cache"]["pos"].cpu().numpy())
        self._commit(self.draft_pool, sids, out["draft_cache"], out["draft_cache"]["pos"].cpu().numpy())

        # timing/energy: the shared cost schedule (costs.py) - draft = K+1
        # *sequential* single-token steps (weights re-read per step);
        # target = one verify pass over K+1 positions
        ctx = int(np.mean([self.pool.seq(s).length for s in sids]))
        draft_chip, c_d, c_t = spec_round_charges(
            self.kind, self.cfg, self.draft_cfg,
            self.new_chip, self.old_chip, b, ctx, k)
        self._charge(draft_chip, c_d)
        self._charge(self.new_chip, c_t, at_s=self.clock + c_d.time_s)
        if self.kind == "dsd":
            self.link_bytes += out["bytes_token_ids"] + out["bytes_draft_probs"]
        round_t = spec_round_time(
            self.kind, c_d, c_t, self.interconnect,
            out.get("bytes_token_ids", 0), out.get("bytes_draft_probs", 0))
        self.clock += self._dilate(self.clock, round_t)

        toks = out["tokens"].cpu().numpy()
        new_last = out["new_last"].cpu().numpy()
        self.rounds += 1
        self.accepted += int(n_acc.sum())
        self.proposed += b * k
        for i, sid in enumerate(sids):
            r = self.active[sid]
            emit = [int(t) for t in toks[i, : n_acc[i] + 1]]
            overflow = len(r.out_tokens) + len(emit) - r.max_new_tokens
            if overflow > 0:
                emit = emit[: len(emit) - overflow]
            self._emit(r, emit)
            self.last_token[sid] = int(new_last[i])
        self._reap()

    # ------------------------------------------------- continuous batching
    def _admit_continuous(self, sched: ContinuousScheduler,
                          output_len=None) -> None:
        """Move arrived requests into the shared scheduler (FCFS)."""
        while self.waiting and self.waiting[0].arrival_s <= self.clock:
            r = self.waiting.popleft()
            self.active[r.req_id] = r
            # the engine keys blocks by real token CONTENT (the simulator
            # synthesizes equivalent keys from session metadata): two
            # prompts sharing a token prefix share cached blocks
            keys = token_block_keys(r.prompt, self.policy.block_size) \
                if sched.cache is not None else ()
            sched.submit(SchedSeq(
                r.req_id, len(r.prompt),
                r.max_new_tokens if output_len is None else output_len,
                payload=r, priority=class_priority(r.slo_class),
                prefix_keys=keys, deadline_s=r.deadline_s))

    def _expire_sched(self, sched: ContinuousScheduler, t: float) -> None:
        """Abort every expired sequence the scheduler holds (ledger blocks
        and cache refs release through `sched.abort`), then mirror on the
        real pools - the engine twin of ReplicaSim._expire_sched."""
        for seq in (list(sched.waiting) + list(sched.prefilling)
                    + list(sched.running)):
            st = self._expired(seq.payload, t)
            if st is not None:
                sched.abort(seq)
                self._abort(seq.payload, st)

    # ------------------------------------------------- prefix-cache hooks
    def _cache_grab(self, sid: int, i: int):
        """Publish hook: pin block `i` of `sid`'s prompt in the real
        pools. The returned payload rides on the cache node; a later
        match adopts these block ids, eviction derefs them."""
        bid = self.pool.seq(sid).block_table[i]
        self.pool.ref_block(bid)
        if self.draft_pool is not None:
            dbid = self.draft_pool.seq(sid).block_table[i]
            self.draft_pool.ref_block(dbid)
            return (bid, dbid)
        return (bid, None)

    def _cache_drop(self, payload) -> None:
        """Eviction hook: release the pinned pool blocks."""
        bid, dbid = payload
        self.pool.deref_block(bid)
        if dbid is not None:
            self.draft_pool.deref_block(dbid)

    def _adopt_shared(self, cache, seq: SchedSeq) -> None:
        """First chunk of a matched sequence: alias the cached blocks into
        the real pools (ref-counted - the KV is physically shared, never
        copied), so the sequence starts with its matched prefix resident."""
        payloads = cache.acquired_payloads(seq.sid)
        if not payloads:
            return
        toks = len(payloads) * self.policy.block_size
        self.pool.adopt(seq.sid, [p[0] for p in payloads], toks)
        if self.draft_pool is not None:
            self.draft_pool.adopt(seq.sid, [p[1] for p in payloads], toks)
        self._shared_tok[seq.sid] = toks

    def _prefix_tokens(self, r: EngineRequest, upto: int) -> np.ndarray:
        """First `upto` tokens of prompt + committed output (recompute
        prefix for chunked / resumed prefill)."""
        if upto <= len(r.prompt):
            return r.prompt[:upto]
        return np.concatenate(
            [r.prompt, np.asarray(r.out_tokens[: upto - len(r.prompt)],
                                  np.int32)])

    def _chunk_prefill(self, params, cfg, pool: PagedKVPool, sid: int,
                       prefix: np.ndarray, fresh: bool,
                       shared_tok: int = 0):
        """One real prefill chunk: compute the prefix, grow the sequence's
        pool blocks to cover it, scatter the KV. Returns the last-position
        logits (valid first-token logits once the prefill completes).

        `shared_tok` > 0 marks the leading tokens whose KV lives in
        ADOPTED cache blocks: those blocks are aliased by other holders
        and must not be rewritten, so only the suffix scatters (the
        recomputed prefix KV is bit-identical to what the blocks hold -
        causal attention makes a shared token prefix produce shared KV).

        CPU-scale note: the chunk is realized by recomputing the whole
        prefix (the backbone's serve_step is single-token); the KV that
        lands in the pool is identical to a true incremental chunk pass,
        and the *priced* cost is the chunk's (costs.hybrid_step_charges) -
        with a prefix-cache match, the matched tokens never appear in any
        chunk, so they are priced as cached context (per-block KV
        re-reads), not prefill.

        Paged mode replaces the whole-prefix recompute with a true
        incremental pass (`prefill_chunk_paged`): only the new chunk runs
        through the backbone, attending over the sequence's paged cached
        context - including ADOPTED prefix-cache blocks, which are read in
        place instead of recomputed. Dense family only: MoE capacity
        routing is per-group, so an incrementally processed chunk would
        route differently than inside the full prefix."""
        if self.paged and cfg.family == "dense":
            ctx0 = pool.seq(sid).length if pool.has(sid) else 0
            if 0 <= ctx0 < len(prefix):
                return self._chunk_prefill_paged(params, cfg, pool, sid,
                                                 prefix, fresh, ctx0)
        tokens = np.asarray(prefix, np.int32)
        batch = {"tokens": torch.from_numpy(tokens).to(self.device)[None, :]}
        logits, cache = backbone.prefill(params, batch, cfg, self.exec_cfg)
        if fresh:
            pool.allocate(sid, len(prefix))
        else:
            pool.extend(sid, len(prefix) - pool.seq(sid).length)
        if shared_tok:
            pool.scatter_suffix(sid, cache["k"], cache["v"], shared_tok)
        else:
            pool.scatter([sid], cache["k"], cache["v"])
        return logits

    def _chunk_prefill_paged(self, params, cfg, pool: PagedKVPool, sid: int,
                             prefix: np.ndarray, fresh: bool, ctx0: int):
        """Incremental chunk prefill: run only prefix[ctx0:] through the
        backbone against the sequence's paged context, `scatter_chunk` the
        new KV at token granularity. ctx0 is the pool-resident token count
        (= shared_tok on an adopted sequence's first chunk; adopted blocks
        are full and block-aligned, so the first write never touches a
        shared block)."""
        chunk = torch.from_numpy(np.asarray(prefix[ctx0:], np.int32)).to(self.device)
        if fresh:
            pool.allocate(sid, len(prefix))
        else:
            pool.extend(sid, len(prefix) - ctx0)
        table = pool.device_tables([sid], max(pool.blocks_needed(ctx0), 1))[0]
        logits, kc, vc = backbone.prefill_chunk_paged(
            params, pool.k, pool.v, table, ctx0, chunk, cfg, self.exec_cfg)
        pool.scatter_chunk(sid, kc, vc, ctx0)
        return logits

    def _retire_continuous(self, seq: SchedSeq, pool_b: bool = False) -> None:
        r: EngineRequest = seq.payload
        self.active.pop(seq.sid, None)
        self.last_token.pop(seq.sid, None)
        self._shared_tok.pop(seq.sid, None)
        # publish already pinned the prompt blocks the cache keeps (the
        # scheduler's _finish ran first); free() only derefs, so donated
        # and adopted blocks survive the sequence
        self.pool.free(seq.sid)
        if self.draft_pool is not None:
            self.draft_pool.free(seq.sid)
        if pool_b:
            self._ledger_b.free(seq.sid)
        self._finish(r)

    def _step_continuous(self) -> bool:
        """One continuous-policy iteration (standalone/spec/dsd).

        Asks the shared `ContinuousScheduler` for a `StepPlan`, executes
        it with real forwards, and prices it through the same
        `costs.hybrid_step_charges` the simulator charges - so on an
        identical workload both executors replay the identical schedule
        (tests/test_engine_sim_parity.py, continuous rows).

        Spans (repro_torch.tracing): `engine.step` around it all, then
        `engine.plan`, an `engine.prefill` a chunk, `engine.decode`, and
        `engine.sync` around each copy of sampled tokens to the host."""
        sched = self._sched
        with tracing.span("engine.step") as step:
            with tracing.span("engine.plan"):
                while True:
                    if self.clock >= self._kill_s:
                        self.kill(self._kill_s)
                        return False
                    self._admit_continuous(sched)
                    if self._lifecycle:
                        self._expire_sched(sched, self.clock)
                    if sched.cache is not None:
                        sched.cache.now_s = self.clock    # carbon lookup only
                    plan = sched.next_plan()
                    if plan is not None:
                        break
                    if not self.waiting:
                        if self._kill_s < float("inf"):
                            self.kill(self._kill_s)
                        return False
                    self.clock = max(self.clock, self.waiting[0].arrival_s)
                for victim in plan.preempted:
                    # scheduler already freed its ledger (and released its
                    # cache refs) and reset the seq for recompute; mirror on
                    # the real pools (tokens are kept - the re-prefill
                    # recomputes prompt + emitted prefix)
                    self._shared_tok.pop(victim.sid, None)
                    self.pool.free(victim.sid)
                    if self.draft_pool is not None:
                        self.draft_pool.free(victim.sid)
                k = self.spec.num_draft_tokens
                hs = hybrid_step_charges(
                    self.kind, self.cfg, self.draft_cfg, self.new_chip, self.old_chip,
                    plan.chunk_specs(), plan.decode_ctxs(), k, self.interconnect)
                for chip_name, cost, rel_s in hs.charges:
                    self._charge(CHIP_DB[chip_name], cost, at_s=self.clock + rel_s)
                t_end = self.clock + self._dilate(self.clock, hs.duration_s)
                if sched.cache is not None:
                    sched.cache.now_s = t_end             # publish at step-end time
            step.set("chunks", len(plan.chunks))
            step.set("decodes", len(plan.decodes))
            for ch in plan.chunks:
                seq = ch.seq
                r: EngineRequest = seq.payload
                with tracing.span("engine.prefill"):
                    prefix = self._prefix_tokens(r, ch.ctx_before + ch.tokens)
                    if sched.cache is not None and not self.pool.has(seq.sid):
                        self._adopt_shared(sched.cache, seq)
                    fresh = not self.pool.has(seq.sid)
                    shared = self._shared_tok.get(seq.sid, 0)
                    logits = self._chunk_prefill(self.params, self.cfg, self.pool,
                                                 seq.sid, prefix, fresh,
                                                 shared_tok=shared)
                    if self.kind in ("spec", "dsd"):
                        self._chunk_prefill(self.draft_params, self.draft_cfg,
                                            self.draft_pool, seq.sid, prefix,
                                            fresh, shared_tok=shared)
                    if sched.complete_chunk(seq, ch.tokens):
                        if seq.emitted == 0:
                            with tracing.span("engine.sync"):
                                tok = int(self._sample(logits)[0])
                            r.out_tokens.append(tok)
                            r.ttft_s = t_end - r.arrival_s
                            r.first_token_s = r.last_token_s = t_end
                            if sched.note_first_token(seq):
                                self._retire_continuous(seq)
                                continue
                        self.last_token[seq.sid] = r.out_tokens[-1]
            if plan.decodes:
                if self.kind in ("spec", "dsd"):
                    self._continuous_spec_round(plan.decodes, t_end)
                else:
                    self._continuous_decode(plan.decodes, t_end)
            self.clock = t_end
            return True

    def _continuous_decode(self, decodes: "list[SchedSeq]",
                           t_end: float) -> None:
        sched = self._sched
        sids = [s.sid for s in decodes]
        with tracing.span("engine.decode"):
            tokens = self._ints([self.last_token[s] for s in sids])
            logits = self._decode_logits(self.pool, sids, tokens)
        with tracing.span("engine.sync"):
            new = self._sample(logits)
        for seq, tok in zip(decodes, new):
            r: EngineRequest = seq.payload
            r.out_tokens.append(int(tok))
            r.last_token_s = t_end
            self.last_token[seq.sid] = int(tok)
            if sched.note_decode(seq, 1):
                self._retire_continuous(seq)

    def _continuous_spec_round(self, decodes: "list[SchedSeq]",
                               t_end: float) -> None:
        sched = self._sched
        k = self.spec.num_draft_tokens
        sids = [s.sid for s in decodes]
        tcache = self._gather(self.pool, sids, k + 1)
        dcache = self._gather(self.draft_pool, sids, k + 1)
        last = self._ints([self.last_token[s] for s in sids])
        out = spec_decode_round(
            self.params, self.cfg, tcache,
            self.draft_params, self.draft_cfg, dcache,
            last, self.spec, self.gen, self.exec_cfg)
        n_acc = out["n_accepted"].cpu().numpy()
        self._commit(self.pool, sids, out["target_cache"],
                     out["target_cache"]["pos"].cpu().numpy())
        self._commit(self.draft_pool, sids, out["draft_cache"],
                     out["draft_cache"]["pos"].cpu().numpy())
        if self.kind == "dsd":
            self.link_bytes += out["bytes_token_ids"] + out["bytes_draft_probs"]
        toks = out["tokens"].cpu().numpy()
        new_last = out["new_last"].cpu().numpy()
        self.rounds += 1
        self.accepted += int(n_acc.sum())
        self.proposed += len(sids) * k
        for i, seq in enumerate(list(decodes)):
            r: EngineRequest = seq.payload
            emit = [int(t) for t in toks[i, : n_acc[i] + 1]]
            overflow = len(r.out_tokens) + len(emit) - r.max_new_tokens
            if overflow > 0:
                emit = emit[: len(emit) - overflow]
            r.out_tokens.extend(emit)
            r.last_token_s = t_end
            self.last_token[seq.sid] = int(new_last[i])
            if sched.note_decode(seq, len(emit)):
                self._retire_continuous(seq)

    # ------------------------------------------------------ continuous dpd
    def _step_continuous_dpd(self) -> bool:
        """Continuous dpd on the engine's single clock.

        Pool A batches waiting prompts into shared chunked-prefill steps
        (the shared `build_dpd_prefill_scheduler` schedule); completed
        prompts serialize their KV transfer into the clock (the engine's
        single-clock view of the FIFO link, like the serialized path) and
        queue for pool B. Pool B admits block-granularly against the
        shared `build_dpd_decode_ledger` and decodes with per-sequence
        context sums. Storage stays in the one physical `PagedKVPool`
        (pools are logical on CPU); the two ledgers model each chip's
        HBM."""
        sched = self._sched_a
        while True:
            if self.clock >= self._kill_s:
                self.kill(self._kill_s)
                return False
            self._admit_continuous(sched, output_len=1)
            if self._lifecycle:
                self._expire_sched(sched, self.clock)
                self._expire_pool_b()
            if sched.cache is not None:
                sched.cache.now_s = self.clock    # carbon lookup only
            plan = sched.next_plan()
            if plan is not None:
                self._dpd_prefill_step(plan)
                return True
            self._dpd_admit()
            if self._decoding_b:
                self._dpd_decode_step()
                return True
            if not self.waiting:
                if self._kill_s < float("inf"):
                    self.kill(self._kill_s)
                return False
            self.clock = max(self.clock, self.waiting[0].arrival_s)

    def _expire_pool_b(self) -> None:
        """Expire pool-B state at the engine clock: queued (shipped-KV)
        entries hold no pool-B ledger blocks but do hold real pool blocks;
        decoding sequences free both."""
        now = self.clock
        for r in self._ready_b.purge(
                lambda it: self._expired(it, now) is not None):
            self._abort(r, self._expired(r, now))
        for seq in [s for s in self._decoding_b
                    if self._expired(s.payload, now)]:
            self._ledger_b.free(seq.sid)
            self._decoding_b.remove(seq)
            self._abort(seq.payload, self._expired(seq.payload, now))

    def _dpd_prefill_step(self, plan) -> None:
        sched = self._sched_a
        for victim in plan.preempted:
            # wedged-pool recompute: scheduler freed its ledger; mirror on
            # the real pool (the re-prefill recomputes the prompt)
            self.pool.free(victim.sid)
            self._shared_tok.pop(victim.sid, None)
        hs = hybrid_step_charges(
            "dpd", self.cfg, None, self.new_chip, self.old_chip,
            plan.chunk_specs(), (), 0, self.interconnect)
        for chip_name, cost, rel_s in hs.charges:
            self._charge(CHIP_DB[chip_name], cost, at_s=self.clock + rel_s)
        t_end = self.clock + self._dilate(self.clock, hs.duration_s)
        if sched.cache is not None:
            sched.cache.now_s = t_end
        tx_total = 0.0
        for ch in plan.chunks:
            seq = ch.seq
            r: EngineRequest = seq.payload
            if sched.cache is not None and not self.pool.has(seq.sid):
                self._adopt_shared(sched.cache, seq)
            fresh = not self.pool.has(seq.sid)
            shared = self._shared_tok.get(seq.sid, 0)
            prefix = self._prefix_tokens(r, ch.ctx_before + ch.tokens)
            logits = self._chunk_prefill(self.params, self.cfg, self.pool,
                                         seq.sid, prefix, fresh,
                                         shared_tok=shared)
            if not sched.complete_chunk(seq, ch.tokens):
                continue
            tok = int(self._sample(logits)[0])
            r.out_tokens.append(tok)
            r.ttft_s = t_end - r.arrival_s
            r.first_token_s = r.last_token_s = t_end
            sched.note_first_token(seq)       # retires the pool-A seq
            nbytes = dpd_kv_bytes(self.cfg, len(r.prompt))
            self.link_bytes += nbytes
            tx_total += self.interconnect.transfer_time(nbytes)
            if r.done:
                self.active.pop(seq.sid, None)
                self.pool.free(seq.sid)
                self._shared_tok.pop(seq.sid, None)
                self._finish(r)
            else:
                self.last_token[seq.sid] = tok
                # KV transfers serialize on the link after t_end in chunk
                # order: this prompt's KV lands at t_end + tx so far
                self._ready_b.push(t_end + tx_total,
                                   class_priority(r.slo_class), r)
        self.clock = t_end + tx_total

    def _dpd_admit(self) -> None:
        ledger = self._ledger_b
        while len(self._ready_b) and len(self._decoding_b) < self.max_batch:
            entry = self._ready_b.peek_eligible(self.clock)
            if entry is None:
                break
            r: EngineRequest = entry[4]
            emitted = len(r.out_tokens)
            kv0 = len(r.prompt) + emitted - 1
            # watermark: keep one growth block per active sequence
            if ledger.blocks_needed(kv0) > \
                    ledger.free_blocks - len(self._decoding_b) - 1:
                if not self._decoding_b and ledger.used_blocks == 0:
                    raise OutOfBlocks(
                        "dpd decode pool cannot fit one sequence (need "
                        f"{ledger.blocks_needed(kv0)} blocks of "
                        f"{ledger.num_blocks})")
                break
            seq = SchedSeq(r.req_id, len(r.prompt), r.max_new_tokens,
                           payload=r, priority=class_priority(r.slo_class))
            seq.prefilled = seq.prefill_target
            seq.kv = kv0
            seq.emitted = emitted
            ledger.allocate(seq.sid, kv0)
            self._decoding_b.append(seq)
            self._ready_b.pop(entry)

    def _dpd_decode_step(self) -> None:
        ledger = self._ledger_b
        # block-pressure step composition, shared with the simulator
        # (batching.plan_dpd_decode_step): boundary-crossers get the free
        # blocks class-first, others stall
        stepping, victim = plan_dpd_decode_step(self._decoding_b, ledger)
        if not stepping:
            if victim is None:
                raise OutOfBlocks(
                    f"dpd decode pool of {ledger.num_blocks} blocks cannot "
                    f"grow a single sequence (kv={self._decoding_b[0].kv})")
            # fully wedged: swap the worst-class youngest back over the
            # link (ledger accounting only - the KV stays in the shared
            # storage pool)
            self._decoding_b.remove(victim)
            ledger.free(victim.sid)
            nbytes = dpd_kv_bytes(self.cfg, victim.kv)
            self.link_bytes += nbytes
            self.clock += self.interconnect.transfer_time(nbytes)
            self._ready_b.push(self.clock, victim.priority, victim.payload)
            return
        sids = [s.sid for s in stepping]
        ctxs = tuple(s.ctx for s in stepping)
        tokens = self._ints([self.last_token[s] for s in sids])
        logits = self._decode_logits(self.pool, sids, tokens)
        new = self._sample(logits)
        hs = hybrid_step_charges(
            "dpd", self.cfg, None, self.new_chip, self.old_chip,
            (), ctxs, 0, self.interconnect)
        for chip_name, cost, rel_s in hs.charges:
            self._charge(CHIP_DB[chip_name], cost, at_s=self.clock + rel_s)
        # queued pool-B entries age one level per age_steps decode rounds
        # they sit out (rounds starting at/after their link arrival)
        self._ready_b.note_round(self.clock)
        self.clock += self._dilate(self.clock, hs.duration_s)
        for seq, tok in zip(stepping, new):
            r: EngineRequest = seq.payload
            r.out_tokens.append(int(tok))
            r.last_token_s = self.clock
            self.last_token[seq.sid] = int(tok)
            seq.emitted += 1
            seq.kv += 1
            ledger.extend_to(seq.sid, seq.kv)
            if seq.remaining <= 0:
                self._decoding_b.remove(seq)
                self._retire_continuous(seq, pool_b=True)

    def _emit(self, r: EngineRequest, tokens: list[int]) -> None:
        r.out_tokens.extend(tokens)
        r.last_token_s = self.clock

    def _reap(self) -> None:
        for sid in [s for s, r in self.active.items() if r.done]:
            r = self.active.pop(sid)
            self.last_token.pop(sid, None)
            self.pool.free(sid)
            if self.draft_pool is not None:
                self.draft_pool.free(sid)
            self._finish(r)

    def _finish(self, r: EngineRequest) -> None:
        if r.req_id in self.active:  # pragma: no cover
            del self.active[r.req_id]
        self.finished.append(r)

    # ------------------------------------------------------------------
    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else float("nan")
