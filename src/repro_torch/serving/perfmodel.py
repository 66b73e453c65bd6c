"""Analytic per-chip performance and power model (roofline-based).

This container is CPU-only, so wall-clock timing of the paper's GPUs / the
target TPUs is impossible. Instead, every serving-layer latency/energy
number comes from a first-principles roofline over the model's analytic
FLOP/byte counts and the chip specs in core/carbon.py:

    t_step = max(flops / (peak * eff_f),  bytes / (hbm_bw * eff_b))

The same interface (`PerfModel`) is what a real-TPU profiler would
implement with device telemetry (see core/profiler.py). The model
reproduces the paper's qualitative structure by construction *and* its
quantitative claims within tolerance (benchmarks/fig2/fig3): prefill is
compute-bound, decode is memory-bound, energy/token falls with batching
until the chip saturates near TDP (§3.1 Takeaways 1-2).

Power: P = idle + (TDP - idle) * util, with util a weighted mix of MXU and
HBM occupancy during the step - calibrated so a saturated compute-bound
phase draws ~TDP and a small-batch memory-bound decode draws well below it
(paper Fig. 3).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib

from repro_torch.core.carbon import ChipSpec
from repro_torch.models.config import ModelConfig

# achievable fractions of peak (serving-grade kernels). These defaults are
# literature values; `calibrated()` below swaps in constants fitted from
# measured kernel timings (benchmarks/kernel_calibration.py artifact).
EFF_FLOPS = 0.55
EFF_BW = 0.75
# power mixing weights (MXU vs HBM occupancy)
W_FLOP, W_MEM = 0.65, 0.35
# fixed per-iteration engine overhead (scheduling, sampling, host sync) -
# calibrated against vLLM-class serving stacks (paper Fig. 2 latency floors)
PREFILL_OVERHEAD_S = 8e-3
DECODE_OVERHEAD_S = 3e-3

# committed calibration artifact (benchmarks/kernel_calibration.py output)
ARTIFACT_PATH = (pathlib.Path(__file__).resolve().parents[3]
                 / "benchmarks" / "artifacts" / "kernel_calibration.json")


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured replacements for the module's roofline constants.

    Produced by `benchmarks/kernel_calibration.py`: it times the paged
    decode / fused chunked-prefill steps across a batch x context grid on
    the host device, measures the host's own peak FLOPs and memory
    bandwidth, and jointly fits (eff_flops, eff_bw, per-kind overheads) in

        t_step = max(flops / (peak * eff_flops),
                     bytes / (bw * eff_bw)) + overhead

    by minimising the worst-case relative error over the measured grid -
    the same max() the roofline predicts, so a grid point may sit on
    either side of the compute/memory ridge without biasing the fit.
    `calibrated()` applies the fit to this module so
    `hybrid_step_cost` predictions track the measured step times within
    the artifact's stated tolerance (tests/test_calibration.py pins it)."""

    eff_flops: float = EFF_FLOPS
    eff_bw: float = EFF_BW
    prefill_overhead_s: float = PREFILL_OVERHEAD_S
    decode_overhead_s: float = DECODE_OVERHEAD_S
    source: str = "defaults"

    @classmethod
    def load(cls, path: "str | os.PathLike | None" = None) -> "Calibration":
        """Committed artifact -> Calibration; literature defaults when the
        artifact is absent (fresh clone before any calibration run)."""
        p = pathlib.Path(path) if path is not None else ARTIFACT_PATH
        if not p.exists():
            return cls()
        with open(p) as f:
            art = json.load(f)
        c = art["calibration"]
        return cls(eff_flops=c["eff_flops"], eff_bw=c["eff_bw"],
                   prefill_overhead_s=c["prefill_overhead_s"],
                   decode_overhead_s=c["decode_overhead_s"], source=str(p))


@contextlib.contextmanager
def calibrated(calib: "Calibration | str | os.PathLike | None" = None):
    """Apply a measured `Calibration` to the module constants for the
    duration of the block. `_roofline` reads the module globals at call
    time, so every cost inside the block uses the fitted constants.
    Pass nothing to load the committed artifact."""
    global EFF_FLOPS, EFF_BW, PREFILL_OVERHEAD_S, DECODE_OVERHEAD_S
    if not isinstance(calib, Calibration):
        calib = Calibration.load(calib)
    saved = (EFF_FLOPS, EFF_BW, PREFILL_OVERHEAD_S, DECODE_OVERHEAD_S)
    EFF_FLOPS, EFF_BW = calib.eff_flops, calib.eff_bw
    PREFILL_OVERHEAD_S = calib.prefill_overhead_s
    DECODE_OVERHEAD_S = calib.decode_overhead_s
    try:
        yield calib
    finally:
        EFF_FLOPS, EFF_BW, PREFILL_OVERHEAD_S, DECODE_OVERHEAD_S = saved


@dataclasses.dataclass(frozen=True)
class StepCost:
    time_s: float
    energy_j: float
    flops: float
    bytes_hbm: float
    util: float

    @property
    def power_w(self) -> float:
        return self.energy_j / self.time_s if self.time_s > 0 else 0.0


def _attn_layers(cfg: ModelConfig) -> int:
    return cfg.num_attn_layers


def prefill_cost(cfg: ModelConfig, chip: ChipSpec, batch: int, prompt_len: int,
                 dtype_bytes: int = 2) -> StepCost:
    """One prefill pass over `batch` prompts of `prompt_len` tokens."""
    tokens = batch * prompt_len
    flops = 2.0 * cfg.active_param_count() * tokens
    if cfg.attn is not None:
        a = cfg.attn
        # causal qk + av: 2 matmuls * 2 flops * (S^2/2) * H * hd per layer
        flops += 2.0 * _attn_layers(cfg) * a.num_heads * a.head_dim * prompt_len * tokens
    w_bytes = cfg.param_count() * dtype_bytes
    act_bytes = 12.0 * tokens * cfg.d_model * dtype_bytes  # streamed activations
    kv_bytes = tokens * cfg.kv_bytes_per_token(dtype_bytes)
    return _roofline(chip, flops, w_bytes + act_bytes + kv_bytes,
                     overhead_s=PREFILL_OVERHEAD_S)


def decode_cost(cfg: ModelConfig, chip: ChipSpec, batch: int, context_len: int,
                dtype_bytes: int = 2, new_tokens: int = 1) -> StepCost:
    """One decode iteration emitting `new_tokens` per sequence (new_tokens>1
    = the speculative-verify chunk on the target model)."""
    tokens = batch * new_tokens
    flops = 2.0 * cfg.active_param_count() * tokens
    if cfg.attn is not None:
        a = cfg.attn
        flops += 4.0 * _attn_layers(cfg) * a.num_heads * a.head_dim * context_len * tokens
    w_bytes = cfg.param_count() * dtype_bytes
    kv_bytes = batch * context_len * cfg.kv_bytes_per_token(dtype_bytes)
    state_bytes = batch * cfg.state_bytes()
    act_bytes = 12.0 * tokens * cfg.d_model * dtype_bytes
    return _roofline(chip, flops, w_bytes + kv_bytes + state_bytes + act_bytes,
                     overhead_s=DECODE_OVERHEAD_S)


def _roofline(chip: ChipSpec, flops: float, bytes_hbm: float,
              overhead_s: float = 0.0) -> StepCost:
    t_f = flops / (chip.peak_flops * EFF_FLOPS)
    t_b = bytes_hbm / (chip.hbm_bandwidth * EFF_BW)
    t_dev = max(t_f, t_b, 1e-9)
    t = t_dev + overhead_s
    util = (W_FLOP * (t_f / t_dev) + W_MEM * (t_b / t_dev)) * (t_dev / t)
    power = chip.idle_power_w + (chip.max_power_w - chip.idle_power_w) * util
    return StepCost(time_s=t, energy_j=power * t, flops=flops, bytes_hbm=bytes_hbm, util=util)


def calibration_state() -> "tuple[float, float, float, float]":
    """Snapshot of the roofline constants `calibrated()` swaps at call time.

    Cost memos key their validity on this tuple: entries priced under one
    calibration must not be served under another (`costs.HybridPricer`)."""
    return (EFF_FLOPS, EFF_BW, PREFILL_OVERHEAD_S, DECODE_OVERHEAD_S)


# Integer aggregates that fully determine a hybrid step's cost for a fixed
# (cfg, chip, new_tokens): (chunk_tok, a1, s_sc, n_dec, a2) - see
# `hybrid_step_key`. Used as memo keys by costs.HybridPricer and computed
# vectorized by the lockstep fleet core.
HybridKey = tuple[int, int, int, int, int]


def hybrid_step_key(chunks: "tuple[tuple[int, int], ...] | list" = (),
                    decode_ctxs: "tuple[int, ...] | list" = ()) -> HybridKey:
    """Integer composition aggregates of one hybrid step.

        chunk_tok = sum(c)            prefill tokens this step
        a1        = sum(c * (2s + c)) causal-attention key count (x2 flops)
        s_sc      = sum(s + c)        KV tokens touched by chunks
        n_dec     = len(decode_ctxs)  decode participants
        a2        = sum(decode_ctxs)  decode context tokens

    Every accumulated term in `hybrid_step_cost` is an integer-valued
    float below 2**53 at realistic model scales, so float accumulation is
    exact and order-independent - computing the cost from these exact
    Python-int aggregates is bit-identical to the per-chunk/per-ctx loops.
    That makes the tuple a sound memo key: same key, same StepCost."""
    chunk_tok = a1 = s_sc = a2 = 0
    for c, s in chunks:
        chunk_tok += c
        a1 += c * (2 * s + c)
        s_sc += s + c
    for ctx in decode_ctxs:
        a2 += ctx
    return (chunk_tok, a1, s_sc, len(decode_ctxs), a2)


def hybrid_step_cost_from_key(cfg: ModelConfig, chip: ChipSpec,
                              key: HybridKey,
                              new_tokens: int = 1,
                              dtype_bytes: int = 2) -> StepCost:
    """`hybrid_step_cost` evaluated from precomputed integer aggregates."""
    chunk_tok, a1, s_sc, n_dec, a2 = key
    dec_tok = n_dec * new_tokens
    tokens = chunk_tok + dec_tok
    flops = 2.0 * cfg.active_param_count() * tokens
    kv_per_tok = cfg.kv_bytes_per_token(dtype_bytes)
    kv_bytes = 0.0
    if cfg.attn is not None:
        a = cfg.attn
        unit = _attn_layers(cfg) * a.num_heads * a.head_dim
        # causal: 2 matmuls * 2 flops * (c*s + c^2/2) keys per layer
        flops += 2.0 * unit * a1
        flops += 4.0 * unit * a2 * new_tokens
    kv_bytes += s_sc * kv_per_tok             # re-read cached ctx + write chunk
    kv_bytes += a2 * kv_per_tok
    w_bytes = cfg.param_count() * dtype_bytes
    act_bytes = 12.0 * tokens * cfg.d_model * dtype_bytes
    state_bytes = n_dec * cfg.state_bytes()
    overhead = PREFILL_OVERHEAD_S if chunk_tok else DECODE_OVERHEAD_S
    return _roofline(chip, flops, w_bytes + act_bytes + kv_bytes + state_bytes,
                     overhead_s=overhead)


def hybrid_step_cost(cfg: ModelConfig, chip: ChipSpec,
                     chunks: "tuple[tuple[int, int], ...] | list" = (),
                     decode_ctxs: "tuple[int, ...] | list" = (),
                     new_tokens: int = 1,
                     dtype_bytes: int = 2) -> StepCost:
    """One mixed (chunked-prefill + decode) iteration in a single roofline pass.

    The continuous-batching scheduler (serving/batching.py) builds each
    engine step as a hybrid batch: `chunks` is a sequence of
    `(chunk_tokens, ctx_cached)` prefill chunks (the chunk attends causally
    to `ctx_cached` already-cached tokens plus itself), `decode_ctxs` is
    the per-sequence context length of every decode participant, each
    emitting `new_tokens` (k+1 for a speculative verify pass). Weights are
    read ONCE for the whole step - that shared read is the throughput win
    of hybrid batching over serialized prefill.

    Exact degeneracies (relied on by the serialized-equivalence property
    test): a single whole-prompt chunk with nothing cached equals
    `prefill_cost(cfg, chip, 1, prompt_len)` bit-for-bit, and an empty
    chunk list equals `decode_cost(cfg, chip, b, ctx)` when every context
    is `ctx`. Unlike `decode_cost`'s batch-mean context, decode KV traffic
    and attention FLOPs here are summed per sequence - exact under the
    roofline, so long-context stragglers are no longer undercharged.

    The cost is a pure function of the `hybrid_step_key` aggregates (exact
    integer sums - see its docstring), which is what makes the keyed memo
    in `costs.HybridPricer` and the lockstep fleet core bit-exact."""
    return hybrid_step_cost_from_key(cfg, chip,
                                     hybrid_step_key(chunks, decode_ctxs),
                                     new_tokens=new_tokens,
                                     dtype_bytes=dtype_bytes)


def prefix_reuse_bytes(cfg: ModelConfig, tokens: int,
                       dtype_bytes: int = 2) -> float:
    """HBM traffic a prefix-cache hit of `tokens` REPLACES prefill with.

    Matched prompt tokens never appear in any chunk; instead their blocks
    enter subsequent chunks as cached context (`ctx_cached` in
    `hybrid_step_cost`), so the sequence pays one KV re-read per step that
    attends over them - this helper is that per-step re-read cost, the
    `(s + c) * kv_per_tok` term with the hit folded into `s`. The prefill
    FLOPs and write traffic of the matched tokens are skipped entirely."""
    return tokens * cfg.kv_bytes_per_token(dtype_bytes)


def max_concurrency(cfg: ModelConfig, chip: ChipSpec, context_len: int,
                    dtype_bytes: int = 2, reserve_frac: float = 0.1) -> int:
    """How many sequences of `context_len` fit in HBM next to the weights."""
    weights = cfg.param_count() * dtype_bytes
    free = chip.hbm_capacity * (1.0 - reserve_frac) - weights
    per_seq = context_len * cfg.kv_bytes_per_token(dtype_bytes) + cfg.state_bytes()
    if free <= 0:
        return 0
    if per_seq <= 0:
        return 1_000_000
    return max(int(free // per_seq), 0)


@dataclasses.dataclass(frozen=True)
class Interconnect:
    """Inter-pool link (paper: 16 Gbps GCP network between machines)."""

    bandwidth_gbps: float = 16.0
    latency_s: float = 200e-6

    def transfer_time(self, nbytes: float) -> float:
        return self.latency_s + nbytes * 8.0 / (self.bandwidth_gbps * 1e9)


def dsd_round_time(
    t_draft_s: float,
    t_target_s: float,
    link: Interconnect,
    bytes_token_ids: float,
    bytes_draft_probs: float,
    overlap: bool = True,
) -> float:
    """One Disg-Spec-Decode round under the Fig. 7 schedule.

    Token ids (tiny) ship first; the V-times-larger draft-prob tensor is
    needed only *after* the target forward, so its transfer hides behind
    the target compute when `overlap` is on."""
    t_ids = link.transfer_time(bytes_token_ids)
    t_probs = link.transfer_time(bytes_draft_probs)
    if overlap:
        return t_draft_s + t_ids + max(t_target_s, t_probs)
    return t_draft_s + t_ids + t_probs + t_target_s
