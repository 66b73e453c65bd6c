"""The system under test, built from a configuration file, and the open-loop
load generator that feeds it.

The program is repro_torch's `ServingEngine`, driven only through its public
`submit` and `step`. A request is submitted once its wall-clock due time has
passed, at the engine's modelled clock, so the engine counts it as arrived
at once. Each token's time is the host clock when the `step()` that made it
returned (the step ends by copying the sampled tokens to the host).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

# the host clock and sleep the open loop keeps time with (the CPU tests put
# a deterministic clock in their place)
now = time.perf_counter
sleep = time.sleep


@dataclasses.dataclass
class Served:
    """One request of a run as the benchmark saw it."""
    idx: int
    due_s: float
    prompt: np.ndarray
    output_len: int
    engine_req: object = None
    times: list = dataclasses.field(default_factory=list)    # host s of each token
    steps: list = dataclasses.field(default_factory=list)    # step index of each token

    @property
    def tokens(self) -> list[int]:
        return list(self.engine_req.out_tokens) if self.engine_req is not None else []

    @property
    def finished(self) -> bool:
        return len(self.times) >= self.output_len

    @property
    def failed(self) -> bool:
        return self.engine_req is not None and self.engine_req.status != "ok"


@dataclasses.dataclass
class StepObs:
    """One engine step inside a traced window: the context of each decode
    and (cached, new) tokens of each prefill chunk, read off the KV pool."""
    t0: float
    t1: float
    decode_ctx: list          # cached tokens before the step, each decode
    chunks: list              # (cached tokens, chunk tokens) of each prefill chunk
    tokens_out: int


def build_engine(model_cfg, cfg: dict, params, prm: dict, seed: int, device):
    """The engine of ModelConfig `model_cfg` (the family's, from the
    configuration file `cfg`, whose `engine` holds its knobs) over
    `params`, with the kind, `max_batch` and `old_chip` (a CHIP_DB name;
    none if the key is absent) of the cell's workload file `prm`."""
    from repro_torch.models.layers import ExecConfig
    from repro_torch.serving.batching import BatchPolicy
    from repro_torch.serving.engine import ServingEngine
    e = cfg["engine"]
    policy = BatchPolicy(kind=e["batching"], chunk_tokens=e["chunk_tokens"],
                         token_budget=e["token_budget"], block_size=e["block_size"])
    exec_cfg = ExecConfig(use_kernels=e["use_kernels"],
                          moe_group_size=cfg.get("moe_group_size", 4096))
    return ServingEngine(model_cfg, params, kind=prm["kind"], new_chip=e["new_chip"],
                         old_chip=prm.get("old_chip"), max_batch=prm["max_batch"],
                         pool_blocks=e["pool_blocks"],
                         block_size=e["block_size"], temperature=e["temperature"],
                         seed=seed, exec_cfg=exec_cfg, batching=policy, paged=e["paged"],
                         device=device)


def warm_up(eng, mix: dict, vocab: int, max_batch: int, rng: np.random.Generator) -> int:
    """Run the shapes the cell's traffic uses before the window: max_batch
    requests of the mix's prompt sizes, all at once. Request i asks for
    base + i tokens, base being more steps than the prefills take, so all
    of them decode together and then finish one by one: prefill chunks of
    each size run, and the decode batch passes through every size from
    max_batch down to 1. Runs the engine until it is idle; returns the
    steps taken."""
    sizes = [tuple(mix[p]) for p in ("p25", "p50", "p75")]
    prompts = [sizes[(i % 4 + 1) // 2][0] for i in range(max_batch)]
    per_step = max(eng.policy.token_budget - max_batch, 1)
    base = 2 + -(-sum(prompts) // per_step) + len(prompts)
    for i, plen in enumerate(prompts):
        eng.submit(rng.integers(0, vocab, size=plen).astype(np.int32), base + i,
                   arrival_s=eng.clock)
    steps = 0
    while eng.step():
        steps += 1
    return steps


class OpenLoop:
    """Feeds `reqs` (due times relative to `t0` on the host clock) to the
    engine and records every token's host time."""

    def __init__(self, eng, reqs, t0: float):
        self.eng, self.t0 = eng, t0
        self.served = [Served(r.idx, r.due_s, r.prompt, r.output_len) for r in reqs]
        self.pending = deque(sorted(self.served, key=lambda s: s.due_s))
        self.live: list[Served] = []
        self.step_idx = 0
        self.late: list[float] = []          # submit time - due time, each request
        self.observe = False                 # read the pool around each step
        self.obs: list[StepObs] = []
        self.peak_blocks = 0                 # most KV blocks in use after a step

    def waiting(self) -> int:
        """Requests submitted that have no first token yet."""
        return sum(1 for s in self.live if not s.times)

    def now(self) -> float:
        return now() - self.t0

    def _submit_due(self, now: float) -> None:
        while self.pending and self.pending[0].due_s <= now:
            s = self.pending.popleft()
            s.engine_req = self.eng.submit(s.prompt, s.output_len, arrival_s=self.eng.clock)
            self.late.append(now - s.due_s)
            self.live.append(s)

    def _pool_lengths(self) -> dict:
        pool = self.eng.pool
        return {id(s): pool.seq(s.engine_req.req_id).length
                for s in self.live if pool.has(s.engine_req.req_id)}

    def run_until(self, t_end: float) -> None:
        """Step until the host clock passes t_end (a step begun before it
        runs to its end)."""
        while True:
            now = self.now()
            if now >= t_end:
                return
            self._submit_due(now)
            before = self._pool_lengths() if self.observe else None
            t0 = self.now()
            if not self.eng.step():
                nxt = self.pending[0].due_s if self.pending else t_end
                sleep(max(0.0, min(nxt, t_end) - self.now()))
                continue
            t1 = self.now()
            self.step_idx += 1
            pool = self.eng.pool
            self.peak_blocks = max(self.peak_blocks, pool.num_blocks - pool.free_blocks)
            out = 0
            decode_ctx, chunks = [], []
            after = self._pool_lengths() if self.observe else None
            still = []
            for s in self.live:
                n = len(s.engine_req.out_tokens)
                had = len(s.times)
                if self.observe:
                    b = before.get(id(s), 0)
                    if had:
                        if n > had:
                            decode_ctx.append(b)
                    elif id(s) in after and after[id(s)] > b:
                        chunks.append((b, after[id(s)] - b))
                if n > had:
                    s.times.extend([t1] * (n - had))
                    s.steps.extend([self.step_idx] * (n - had))
                    out += n - had
                if len(s.times) < s.output_len and s.engine_req.status == "ok":
                    still.append(s)
            self.live = still
            if self.observe:
                self.obs.append(StepObs(t0, t1, decode_ctx, chunks, out))
