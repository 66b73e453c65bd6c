#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA H100 and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one card
    python3 chip_smoke.py --tree DIR   # the same phases over the port's package
                                 # in DIR/src (a parent commit), no result line

Phases; any failure raises, and the script then exits non-zero and prints
no result:

  device   CUDA present with capability 9.0; the card's name and power limit
           from nvidia-smi.
  build    nvcc builds every kernel from src/repro_torch/csrc (one process
           per source, all at once) and prints each kernel's registers and
           spills (-Xptxas=-v); the tensor-core kernels must not spill at
           head_dim 128, the SASS of the two prefill kernels and of the two
           recurrences must hold HMMA (tensor-core) and LDGSTS (cp.async)
           instructions, that of the two decode kernels LDGSTS, the decodes'
           path instantiations (bf16, one query row a kv head, head_dim 128
           and 80) must not spill, and no instantiation of the two
           recurrences may (their path ones, bf16 at N 64 and N = P = 64,
           among them).
  kernels  each hand-written kernel against its plain PyTorch version
           (impl="torch") on the card, and against the fp32 oracle of
           kernels/ref.py, at the target's and the draft's engine shapes and
           at small ones: grouped heads G in {1, 4, 8}, ragged lengths,
           odd S, a ctx == 0 chunk, pages shared with refcount > 1, a pool
           poisoned with finite +-1e4, bf16 and fp32; flash and dense decode
           also at zamba2's shared-attention shapes (head_dim 80), both
           prefill kernels at the edges of their tensor-core tiles (flash at
           S in {1, 15, 16, 17, 63, 64, 65, 129}, G in {1, 4}, D in {64, 80,
           128}; paged prefill at C in {1, 16, 17, 65} over ctx in {0, 1, 15,
           16, 63, 64, 65}, G in {1, 4, 8}, D in {80, 128}, bs in {8, 16}),
           and both decodes at the edges of their key tiles and splits (fp32,
           keys in {1, 63, 64, 65, 127, 128, 129, 459}, one and four
           sequences, a paged length 0); the WKV
           and SSD recurrences at the recurrent phase's prefill and extend
           shapes from a nonzero state, at small ones (T in {1, 16, 17,
           40}, H in {1, 3}) and at the edges of their chunks (WKV T in {15,
           16, 17, 33}, SSD T in {63, 64, 65, 129}; bf16 and fp32, state0 on
           and off; SSD at N = P = 128, whose bf16 chunk is 32 tokens, T in
           {31, 32, 33, 65} in bf16). Two calls of each kernel at its timed shape (and of the
           recurrences' fp32 route at the path shape) must be bit-identical.
           Then kernel, plain version and one PyTorch library call (the
           yardstick; the port never calls it) are timed at the shapes the
           path runs, the recurrences also on their fp32 route and SSD at
           chunks of 32, 64 and 128 tokens, the decodes also at the serialized
           shapes (one sequence over 459 cached tokens, target and draft),
           with the decodes' split of the keys printed for each; the paged
           kernels, which no one PyTorch call computes off a paged pool, get
           a yardstick of their own: SDPA over K/V pre-gathered contiguous,
           gather excluded.
  engine   ServingEngine at the full width of the paper's llama-7b target
           (bf16, random weights from the port's seeded init), with a
           llama-1b draft for spec/dsd: 4 requests, ragged prompts of a few
           hundred tokens, 16 new tokens each, greedy. standalone
           (serialized paged and dense, continuous paged), dpd, spec, dsd.
           The kernels' launch counts are zeroed before and read after;
           each kind then runs twice more for its wall times (uncounted);
           Then first-token logits of the kernel path (target and draft)
           are held against the plain path on the card, and torch.profiler
           records one more run (device busy share, top kernels by device
           time).
  recurrent  rwkv6-7b (ssm) and then zamba2-2.7b (hybrid) at full width
           (bf16, seeded random weights) through the backbone's entry
           points: prefill of 4 prompts x 451 tokens, 16 greedy serve_steps,
           and an extend_step of 4 tokens from the saved cache, held against
           4 serve_steps from the same cache. Launch counts are checked
           exactly (WKV 32 per rwkv6 prefill/extend; SSD 54 per zamba2
           prefill/extend, flash 9 per zamba2 prefill, decode 9 per zamba2
           step). First-token logits of the kernel path are held against
           the plain path (impl="torch") on the card.
After all path phases every kernel must have launched on a path.

The engine's modelled clock, energy and carbon are the cost model's figures
for the chips it names (a100 new, t4 old), not measurements of this card.
The last lines of standard output are: the nvidia-smi line, one JSON object
{"kernels": [...]}, and {"ok": true, "device": {...}}. The launches there
are the sums over the path phases (engine and recurrent).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak

# Tolerances are on the row-normalised error: for each output row (one
# query's head vector, or one sequence's logits) max|kernel - other| over the
# row, divided by the RMS of the other's row; the largest over all rows. A
# causal row that attends to one key has |o| ~ 1 while one over ~400 keys has
# |o| ~ 0.05, so a limit relative to the whole tensor's max would let the
# late rows be wrong by more than their own size. Each limit is about three
# times the largest reading on an H100 (PERF.md, PR 11 findings).
#   fp32: the kernel and the plain version differ only in summation order
#         (largest reading 3.6e-6)
#   bf16: the plain version rounds its scores to bf16 and its normalised
#         probabilities to bf16 before the value product. The decode kernels
#         keep scores and probabilities in fp32; the two prefill kernels'
#         tensor-core route keeps the scores in fp32 and rounds the
#         unnormalised probabilities to bf16 before P V, dividing by the
#         fp32 sum at the end (largest readings: flash and paged prefill
#         6.3e-2, the decodes 2.7e-2)
#   the recurrences (WKV, SSD) compute to fp32 accuracy from the same
#   inputs in kernel and plain version (chunked): fp32 inputs take the
#   kernel's per-token route, bf16 inputs its chunked tensor-core route with
#   error-compensated bf16 operands (fp32 operands split into three bf16
#   terms); y and the final state differ by summation order over the T steps
#   (largest readings before the chunked route: WKV 3.1e-5 fp32 and 4.7e-5
#   bf16 inputs, SSD 3.7e-5 and 4.7e-5; PERF.md has the current ones)
TOL_PLAIN = {"float32": {"flash_attention": 2e-5, "decode_attention": 2e-5,
                         "paged_decode_attention": 2e-5,
                         "paged_prefill_attention": 2e-5,
                         "rwkv6_wkv": 1e-4, "mamba2_ssd": 1.2e-4},
             "bfloat16": {"flash_attention": 2e-1, "decode_attention": 8e-2,
                          "paged_decode_attention": 8e-2,
                          "paged_prefill_attention": 2e-1,
                          "rwkv6_wkv": 1.5e-4, "mamba2_ssd": 1.5e-4}}
#   against the fp32 oracle a bf16 kernel differs by its output rounding and,
#   in the prefill kernels, by the bf16 probabilities (largest readings:
#   flash 1.3e-2, paged prefill 2.2e-2, the decodes 1.3e-3; half an ulp of
#   an element ~3x its row's RMS is 5.9e-3); the
#   recurrences write fp32, so only the order of their sums differs (largest
#   readings from bf16 inputs before the chunked route: WKV 1.9e-5, SSD
#   3.2e-5)
TOL_ORACLE_BF16 = {"flash_attention": 4e-2, "decode_attention": 1e-2,
                   "paged_decode_attention": 1e-2, "paged_prefill_attention": 6e-2,
                   "rwkv6_wkv": 6e-5, "mamba2_ssd": 1e-4}
#   first-token logits, kernel path vs plain path, both bf16: every layer
#   adds one attention output's bf16 difference (largest reading 9.4e-2)
TOL_LOGITS = 2.5e-1
#   the recurrent models' first-token logits, kernel path vs plain path:
#   the recurrences agree to ~1e-5 in fp32, but a bf16 rounding that flips
#   in one layer grows through the data-dependent decays of the later ones.
#   The phase also measures this noise floor: the plain path against itself
#   with the recurrence's chunk halved (the same function in another fp32
#   summation order). Largest readings 4.3e-1 on both models, the noise
#   floor 4.2e-1 to 4.5e-1 (PERF.md, PR 12)
TOL_LOGITS_REC = 1.3
#   the recurrent models' logits, extend_step of 4 tokens vs 4 serve_steps
#   from the same cache, both bf16: cuBLAS rounds a 4-token GEMM otherwise
#   than a 1-token one, and the difference compounds through every layer and
#   token (largest readings 2.5e-1 for rwkv6-7b and 3.4e-1 for zamba2-2.7b
#   at the 4th token, the same on the plain path, impl="torch", as on the
#   kernel path; PERF.md, PR 12)
TOL_EXTEND = 1.0

PROMPT_LENS = (287, 333, 402, 451)
MAX_NEW = 16
BLOCK = 16
# a serialized decode step's cached tokens, for the decodes' one-sequence
# timings: the longest prompt 8 tokens in
SERIAL_CACHED = max(PROMPT_LENS) + MAX_NEW // 2
# the decodes' key counts at the edges of their 64-key tiles and splits
DECODE_KEYS = (1, 63, 64, 65, 127, 128, 129, 459)
# the recurrent phase: 4 prompts of max(PROMPT_LENS) tokens, MAX_NEW greedy
# serve_steps, then an extend_step of EXTEND tokens
REC_ARCHS = ("rwkv6-7b", "zamba2-2.7b")
REC_BATCH = 4
EXTEND = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ----------------------------------------------------------------- device
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"need an sm_90 card (H100), found capability {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return smi.strip().splitlines()[0].strip()


# ------------------------------------------------------------------ build
def phase_build():
    """Build every kernel; returns {source: ptxas log} for those built now."""
    from repro_torch.kernels import build

    t = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t
    print(f"build: {secs:.1f} s for {len(logs)} sources "
          f"({', '.join(build.SOURCES)})", flush=True)
    for src, out in logs.items():
        for kernel, regs, spills in _ptxas_kernels(out):
            print(f"ptxas {src} {kernel}: {regs} registers, {spills}", flush=True)
            if kernel.endswith("mma_kernel<128>") and not spills.startswith("0 bytes spill stores"):
                raise RuntimeError(f"{src} {kernel} spills at head_dim 128: {spills}")
    return logs


# the decode kernels' instantiations on the serving paths: bf16, one query
# row a kv head (G = 1), llama's head_dim 128 and zamba2's 80
DECODE_PATH = {"decode_attention": ("decode_kernel<bf16,128,1>", "decode_kernel<bf16,80,1>"),
               "paged_decode_attention": ("paged_decode_kernel<bf16,128,1>",
                                          "paged_decode_kernel<bf16,80,1>")}
NO_SPILL = "0 bytes spill stores, 0 bytes spill loads"
# the recurrences' instantiations on the recurrent paths: bf16, the chunked
# tensor-core form at rwkv6-7b's N 64 and zamba2's N 64, P 64 (chunk 64)
REC_PATH = {"rwkv6_wkv": ("wkv_mma_kernel<64>",),
            "mamba2_ssd": ("ssd_mma_kernel<64,64,64>",)}
# the chunks the SSD kernel's chunked form was timed at (mamba2_ssd_launch_chunk)
SSD_CHUNKS = (32, 64, 128)


def phase_sass(logs):
    """The bf16 routes of the prefill kernels and of the two recurrences
    must run on the tensor cores (HMMA), and all six kernels must load
    asynchronously (LDGSTS, the SASS of cp.async); the decodes' path
    instantiations must not spill, and no instantiation of either
    recurrence may spill (their path ones must be among them)."""
    from repro_torch.kernels import build

    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    for src, need in (("flash_attention", ("HMMA", "LDGSTS")),
                      ("paged_prefill_attention", ("HMMA", "LDGSTS")),
                      ("decode_attention", ("LDGSTS",)),
                      ("paged_decode_attention", ("LDGSTS",)),
                      ("rwkv6_wkv", ("HMMA", "LDGSTS")),
                      ("mamba2_ssd", ("HMMA", "LDGSTS"))):
        sass = subprocess.run([str(cuobjdump), "-sass", str(build._lib_path(src))],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        counts = {op: sum(f" {op}." in ln or f" {op} " in ln for ln in sass.splitlines())
                  for op in ("HMMA", "LDGSTS", "LDSM")}
        print(f"sass {src}: {counts}", flush=True)
        if not all(counts[op] for op in need):
            raise RuntimeError(f"{src}: no {' or '.join(need)} instructions in its SASS")
    for src, insts in DECODE_PATH.items():
        if src not in logs:
            print(f"ptxas {src}: built before this run, spills were checked then", flush=True)
            continue
        spills = {k: sp for k, _, sp in _ptxas_kernels(logs[src])}
        for inst in insts:
            if spills.get(inst) != NO_SPILL:
                raise RuntimeError(f"{src} {inst} spills or is missing: {spills.get(inst)}")
        print(f"ptxas {src}: the path instantiations {', '.join(insts)} do not spill",
              flush=True)
    for src, insts in REC_PATH.items():
        if src not in logs:
            print(f"ptxas {src}: built before this run, spills were checked then", flush=True)
            continue
        spills = {k: sp for k, _, sp in _ptxas_kernels(logs[src])}
        missing = [i for i in insts if i not in spills]
        spilling = {k: sp for k, sp in spills.items() if sp != NO_SPILL}
        if missing or spilling:
            raise RuntimeError(f"{src}: path instantiations missing {missing}, "
                               f"instantiations that spill {spilling}")
        print(f"ptxas {src}: none of its {len(spills)} instantiations spills (the path's: "
              f"{', '.join(insts)})", flush=True)


def _ptxas_kernels(log_text: str):
    """(kernel<template args>, registers, spill line) for each entry function
    in a `-Xptxas=-v` log."""
    import re

    out, name, spills = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?\d([A-Za-z_]*kernel)I(\w*?)EEv", line)
        if m:
            args = ("bf16," if "bfloat16" in m.group(2) else "fp32," if m.group(2)[:1] == "f"
                    else "") + ",".join(re.findall(r"Li(\d+)E", m.group(2) + "E"))
            name = f"{m.group(1)}<{args}>"
        elif "spill stores" in line:
            spills = line.split(",", 1)[1].strip()
        elif "Used" in line and "registers" in line and name:
            out.append((name, int(re.search(r"Used (\d+) registers", line).group(1)), spills))
            name = None
    return out


# ---------------------------------------------------------------- helpers
def _rel(a, b) -> tuple[float, float]:
    """(max abs error, largest row-normalised error): rows are the last
    axis, each row's max|a - b| over the RMS of b's row."""
    d = (a.float() - b.float()).abs().reshape(-1, b.shape[-1])
    rms = b.float().reshape(-1, b.shape[-1]).pow(2).mean(-1).sqrt()
    return d.max().item(), (d.amax(-1) / rms.clamp_min(1e-6)).max().item()


def _time_ms(fn, iters: int = 20) -> float:
    """Mean device ms per call, each call after an L2 flush (the 50 MB L2
    would otherwise hold a decode's whole K/V between calls). The flush reads
    64 MB: one that wrote them (zero_) left ~50 MB of dirty lines whose
    write-back fell inside the timed call. The card spins for ~0.5 ms after
    the flush, so the host has queued the call before the start event is
    reached: the time is the device's, without the host's cost of issuing
    the call (a wrapper's checks and allocation)."""
    import torch

    flush = torch.ones(16 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.sum()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


class KernelCheck:
    """Errors, timings and bound of one kernel."""

    def __init__(self, name, source, replaces, kernel):
        self.name, self.source, self.replaces, self.kernel = name, source, replaces, kernel
        self.max_abs_err = 0.0
        self.worst = {}          # dtype -> (largest error vs plain, vs oracle)
        self.cases = 0
        self.timing = {}
        self.timing_d80 = None       # flash/decode at zamba2's head_dim 80 shape
        self.timing_b1 = {}          # the decodes at one sequence: label -> timing
        self.path_launches = 0

    def identical(self, fn, what: str) -> None:
        """Two calls on the same inputs must give the same bits."""
        import torch

        a, b = fn(), fn()
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"{self.name} {what}: two calls differ")
        log(f"  {self.name} {what}: two calls bit-identical")

    def hold(self, got, plain, oracle, dtype, what: str) -> None:
        import torch

        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{self.name} {what}: non-finite output")
        key = str(dtype).split(".")[-1]
        tol = TOL_PLAIN[key][self.name]
        abs_err, rel = _rel(got, plain)
        _, rel_o = _rel(got, oracle)
        tol_o = TOL_ORACLE_BF16[self.name] if key == "bfloat16" else tol
        log(f"  {self.name} {what}: vs plain {rel:.2e} (tol {tol:g}), "
            f"vs fp32 oracle {rel_o:.2e} (tol {tol_o:g})")
        if rel > tol or rel_o > tol_o:
            raise RuntimeError(f"{self.name} {what}: kernel disagrees "
                               f"(vs plain {rel:.3e}, vs oracle {rel_o:.3e})")
        self.max_abs_err = max(self.max_abs_err, abs_err)
        w = self.worst.get(key, (0.0, 0.0))
        self.worst[key] = (max(w[0], rel), max(w[1], rel_o))
        self.cases += 1

    def record(self) -> dict:
        t = self.timing
        rec = {"name": self.name, "route": "cuda", "source": self.source,
               "replaces": self.replaces, "launches": self.path_launches,
               "max_abs_err": self.max_abs_err, "ms": t["ms"], "kernel_ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "library_ratio": _ratio(t["ms"], t["library_ms"])}
        if "yardstick_ms" in t:
            rec.update(yardstick=t["yardstick"], yardstick_ms=t["yardstick_ms"],
                       yardstick_ratio=_ratio(t["ms"], t["yardstick_ms"]))
        if "splits" in t:
            rec["splits"] = t["splits"]
        if "fp32_ms" in t:
            rec["fp32_ms"] = t["fp32_ms"]
        if t.get("chunks"):
            rec["chunk_ms"] = {str(k): v for k, v in t["chunks"].items()}
        if self.timing_d80:
            d80 = dict(self.timing_d80)
            d80["library_ratio"] = _ratio(d80["ms"], d80["library_ms"])
            rec["head_dim_80"] = d80
        if self.timing_b1:
            rec["batch_1"] = {k: dict(v, library_ratio=_ratio(v["ms"], v["library_ms"]),
                                      yardstick_ratio=_ratio(v["ms"], v.get("yardstick_ms")))
                              for k, v in self.timing_b1.items()}
        return rec


def _ratio(ms, library_ms):
    """Kernel time over the yardstick's, timed in the same call."""
    return None if library_ms is None else ms / library_ms


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------- kernels
def phase_kernels(gen):
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pag
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.models.config import AttentionConfig
    from repro_torch.serving.kv_cache import PagedKVPool

    f32, bf16 = torch.float32, torch.bfloat16
    cuda = torch.device("cuda")
    # the decodes' edge cases and one-sequence timings draw from a generator
    # of their own, so the other cases keep the inputs they were first held on
    more = torch.Generator(device=cuda)
    more.manual_seed(1)

    def rand(*shape, dtype=f32, g=None):
        return torch.randn(shape, generator=g or gen, device=cuda).to(dtype)

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=cuda)

    # the target's shapes, and the llama-1b draft's (spec/dsd draft prefill,
    # draft decode steps and draft chunks)
    tgt, dft = get_config("llama-7b"), get_config("llama-1b")
    kvh7, g7, d7 = tgt.attn.num_kv_heads, tgt.attn.num_heads // tgt.attn.num_kv_heads, tgt.attn.head_dim
    kvh1, g1, d1 = dft.attn.num_kv_heads, dft.attn.num_heads // dft.attn.num_kv_heads, dft.attn.head_dim
    spec_k = 4      # draft tokens per spec round in the engine phase
    checks = {
        "flash_attention": KernelCheck(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:81", fla.KERNEL),
        "decode_attention": KernelCheck(
            "decode_attention", "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:75", dec.KERNEL),
        "paged_decode_attention": KernelCheck(
            "paged_decode_attention", "src/repro_torch/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_attention.py:114", pag.DECODE_KERNEL),
        "paged_prefill_attention": KernelCheck(
            "paged_prefill_attention", "src/repro_torch/csrc/paged_prefill_attention.cu",
            "src/repro/kernels/paged_attention.py:236", pag.PREFILL_KERNEL),
        "rwkv6_wkv": KernelCheck(
            "rwkv6_wkv", "src/repro_torch/csrc/rwkv6_wkv.cu",
            "src/repro/kernels/rwkv6_wkv.py:79", wkv.KERNEL),
        "mamba2_ssd": KernelCheck(
            "mamba2_ssd", "src/repro_torch/csrc/mamba2_ssd.cu",
            "src/repro/kernels/mamba2_ssd.py:80", ssd.KERNEL),
    }
    # zamba2's shared attention block (head_dim 80) at the recurrent phase's
    # prefill and decode shapes: those two kernels also get a timing there
    zam = get_config("zamba2-2.7b")
    hz, dz = zam.attn.num_heads, zam.attn.head_dim
    s_rec = max(PROMPT_LENS)
    rec_pos = [s_rec + x for x in (0, 5, 9, MAX_NEW - 1)]      # ragged steps
    rec_slots = s_rec + MAX_NEW + EXTEND                         # the grown cache
    es = 2  # bytes per bf16 element at the timed (main-path) shapes

    # ---- flash: (B, S, H, KV, D, dtype); odd S, G in {1, 4, 8}, then the
    # edges of the tensor-core tiles (64 query rows, 16 a warp, 64-key tiles)
    c = checks["flash_attention"]
    flash_cases = [(1, max(PROMPT_LENS), kvh7 * g7, kvh7, d7, bf16),
                   (1, max(PROMPT_LENS), kvh1 * g1, kvh1, d1, bf16),
                   (REC_BATCH, s_rec, hz, zam.attn.num_kv_heads, dz, bf16),
                   (2, 77, 8, 2, 80, f32),
                   (2, 77, 8, 8, 128, f32), (2, 129, 16, 4, 64, bf16),
                   (1, 200, 32, 4, 128, f32), (3, 33, 8, 1, 32, f32)]
    flash_cases += [(2, s, 2 * g, 2, d, bf16) for s, g, d in itertools.product(
        (1, 15, 16, 17, 63, 64, 65, 129), (1, 4), (64, 80, 128))]
    for b, s, h, kv, d, dt in flash_cases:
        q, k, v = rand(b, s, h, d, dtype=dt), rand(b, s, kv, d, dtype=dt), rand(b, s, kv, d, dtype=dt)
        got = ops.flash_attention(q, k, v)
        plain = ops.flash_attention(q, k, v, impl="torch")
        oracle = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2)).transpose(1, 2)
        c.hold(got, plain, oracle, dt, f"B={b} S={s} H={h} KV={kv} D={d} {dt}")
    b, s, h, kv, d = 1, max(PROMPT_LENS), tgt.attn.num_heads, kvh7, d7
    q, k, v = rand(b, s, h, d, dtype=bf16), rand(b, s, kv, d, dtype=bf16), rand(b, s, kv, d, dtype=bf16)
    qh, kh, vh = q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    c.identical(lambda: ops.flash_attention(q, k, v), "(timed)")
    c.timing = {
        "ms": _time_ms(lambda: ops.flash_attention(q, k, v)),
        "plain_ms": _time_ms(lambda: ops.flash_attention(q, k, v, impl="torch")),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)),
    }
    pairs = b * h * s * (s + 1) / 2
    c.timing["bound_ms"], c.timing["bound_by"] = _bound(
        (2 * b * s * h * d + 2 * b * s * kv * d) * es, 4 * d * pairs)
    b, s, h, kv, d = REC_BATCH, s_rec, hz, zam.attn.num_kv_heads, dz
    q, k, v = rand(b, s, h, d, dtype=bf16), rand(b, s, kv, d, dtype=bf16), rand(b, s, kv, d, dtype=bf16)
    qh, kh, vh = q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    c.timing_d80 = {
        "ms": _time_ms(lambda: ops.flash_attention(q, k, v)),
        "plain_ms": _time_ms(lambda: ops.flash_attention(q, k, v, impl="torch")),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)),
    }
    pairs = b * h * s * (s + 1) / 2
    c.timing_d80["bound_ms"], c.timing_d80["bound_by"] = _bound(
        (2 * b * s * h * d + 2 * b * s * kv * d) * es, 4 * d * pairs)

    # ---- dense decode: (B, KV, G, S, D, dtype, pos); inclusive kpos <= pos;
    # the path's shapes, small ones, then the edges of the 64-key tiles and
    # of the splits (one and four sequences, G 1 and 4) in fp32: a bf16
    # output is one rounding from the oracle's, and where the oracle's fp32
    # value sits on a bf16 midpoint, one ulp of an element ~3x its row's RMS
    # exceeds TOL_ORACLE_BF16 for any kernel (PERF.md, decode findings); so
    # the edges are held where the limit is finer than the rounding, and
    # tests/test_torch_cuda.py holds the bf16 edges against the plain version
    c = checks["decode_attention"]
    main_pos = [n + MAX_NEW // 2 for n in PROMPT_LENS]
    dense_cases = [
        (4, kvh7, g7, max(main_pos) + 1, d7, bf16, main_pos),
        # a spec round's draft steps: the gathered cache is k + 1 wider
        (4, kvh1, g1, max(main_pos) + spec_k + 1, d1, bf16, [x + spec_k for x in main_pos]),
        (REC_BATCH, zam.attn.num_kv_heads, hz // zam.attn.num_kv_heads, rec_slots, dz,
         bf16, rec_pos),
        (2, 4, 2, 100, 80, f32, [0, 99]),
        (3, 2, 4, 100, 64, f32, [0, 50, 99]),
        (2, 4, 8, 333, 128, f32, [1, 332]),
        (2, 8, 1, 65, 32, bf16, [64, 31])]
    dense_cases = [c_ + (gen,) for c_ in dense_cases]
    dense_cases += [(b, 2, g, keys + 2, d7, f32, [keys - 1, keys // 2, 0, keys - 1][:b], more)
                    for keys, b, g in itertools.product(DECODE_KEYS, (1, 4), (1, 4))]
    for b, kv, g, s, d, dt, pos, src in dense_cases:
        q = rand(b, 1, kv * g, d, dtype=dt, g=src)
        kc, vc = rand(b, kv, s, d, dtype=dt, g=src), rand(b, kv, s, d, dtype=dt, g=src)
        p = ints(pos)
        got = ops.decode_attention(q, kc, vc, p)
        plain = ops.decode_attention(q, kc, vc, p, impl="torch")
        oracle = ref.decode_attention_ref(q[:, 0].reshape(b, kv, g, d), kc, vc, p).reshape(b, 1, kv * g, d)
        what = f"B={b} KV={kv} G={g} S={s} D={d} pos={pos} {dt}"
        c.hold(got, plain, oracle, dt, what)
        # finite poison past pos must leave the output bit-identical
        slots = torch.arange(s, device=cuda)[None, None, :, None] > p[:, None, None, None]
        kp, vp = kc.masked_fill(slots, 1e4), vc.masked_fill(slots, -1e4)
        if not torch.equal(ops.decode_attention(q, kp, vp, p), got):
            raise RuntimeError(f"decode_attention {what}: poison past pos was observed")

    def splits(b, kv, g, max_keys):
        """The decodes' split of the keys, (splits, keys a split), where this
        tree's wrappers split them."""
        if not hasattr(dec, "decode_splits"):
            return None
        return list(dec.decode_splits(b, kv, dec.row_groups(g), max_keys, dec.sm_count(cuda)))

    def split_sweep(t, fn, b, kv, g, max_keys):
        """Time fn again with the split aimed at 2 and 4 blocks an SM (the
        wrappers aim at dec.BLOCKS_PER_SM): [splits, keys a split, ms]."""
        if not hasattr(dec, "decode_splits"):
            return
        from unittest import mock

        t["per_sm"] = {}
        for target in (2, 4):
            with mock.patch.object(dec, "BLOCKS_PER_SM", target):
                t["per_sm"][target] = splits(b, kv, g, max_keys) + [_time_ms(fn)]

    def time_dense(b, kv, g, d, pos, s=None, src=gen):
        s = s or max(pos) + 1
        q = rand(b, 1, kv * g, d, dtype=bf16, g=src)
        kc, vc = rand(b, kv, s, d, dtype=bf16, g=src), rand(b, kv, s, d, dtype=bf16, g=src)
        p = ints(pos)
        mask = torch.arange(s, device=cuda)[None, None, None, :] <= p[:, None, None, None]
        c.identical(lambda: ops.decode_attention(q, kc, vc, p), f"B={b} KV={kv} D={d} (timed)")
        t = {"ms": _time_ms(lambda: ops.decode_attention(q, kc, vc, p)),
             "plain_ms": _time_ms(lambda: ops.decode_attention(q, kc, vc, p, impl="torch")),
             "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                 q.transpose(1, 2), kc, vc, attn_mask=mask, enable_gqa=True)),
             "splits": splits(b, kv, g, s)}
        split_sweep(t, lambda: ops.decode_attention(q, kc, vc, p), b, kv, g, s)
        keys = sum(x + 1 for x in pos)
        t["bound_ms"], t["bound_by"] = _bound(
            2 * keys * kv * d * es + 2 * b * kv * g * d * es + 4 * b, 4 * d * kv * g * keys)
        return t

    c.timing = time_dense(4, kvh7, g7, d7, main_pos)
    c.timing_d80 = time_dense(REC_BATCH, zam.attn.num_kv_heads, hz // zam.attn.num_kv_heads,
                              dz, rec_pos, rec_slots)
    # the serialized policy decodes one sequence at a time: 459 cached tokens
    c.timing_b1 = {"llama-7b": time_dense(1, kvh7, g7, d7, [SERIAL_CACHED], src=more),
                   "llama-1b": time_dense(1, kvh1, g1, d1, [SERIAL_CACHED], src=more)}

    # ---- paged decode, through a real PagedKVPool: shared (adopted) pages
    # with refcount > 1, ragged lengths incl. 0, the dump page poisoned; then
    # the edges of the key tiles and splits, in fp32 as for the dense decode
    c = checks["paged_decode_attention"]

    def paged_case(cfg_attn, lengths, share, dt, bs, src=gen):
        cfg = dataclasses.replace(get_config("llama-7b"), num_layers=1, attn=cfg_attn)
        kv, d = cfg_attn.num_kv_heads, cfg_attn.head_dim
        g = cfg_attn.num_heads // kv
        need = sum(-(-(n + 1) // bs) for n in lengths) + 8
        pool = PagedKVPool(cfg, need, bs, dtype=dt, device=cuda)
        pool.k.fill_(1e4)
        pool.v.fill_(-1e4)
        sids = list(range(len(lengths)))
        donor = None
        for sid, n in zip(sids, lengths):
            if share and donor is not None and n >= share:
                pool.adopt(sid, pool.seq(donor).block_table[: share // bs], share)
                pool.extend(sid, n - share)
                start = share
            else:
                pool.allocate(sid, n)
                start = 0
                if share and n >= share:
                    donor = sid
            kc = rand(1, kv, n - start, d, dtype=dt, g=src)
            if n > start:
                pool.scatter_chunk(sid, kc, rand(1, kv, n - start, d, dtype=dt, g=src), start)
        if share:
            shared = pool.seq(donor).block_table[: share // bs]
            if min(pool.block_refs(x) for x in shared) < 2:
                raise RuntimeError("paged decode case did not share pages")
        max_len = max(lengths) + 1
        tables = pool.device_tables(sids, pool.blocks_needed(max_len))
        b = len(lengths)
        q = rand(b, 1, kv * g, d, dtype=dt, g=src)
        kn, vn = rand(b, 1, kv, d, dtype=dt, g=src), rand(b, 1, kv, d, dtype=dt, g=src)
        lens = ints(lengths)
        args = (q, pool.k[0], pool.v[0], tables, lens, kn, vn, max_len)
        return pool, args, (b, kv, g, d)

    paged_dec_cases = [(tgt.attn, main_pos, 0, bf16, BLOCK),
                       (AttentionConfig(8, 2, 64), [0, 17, 40], 16, f32, 16),
                       (AttentionConfig(32, 4, 128), [5, 23, 40, 17], 16, f32, 8),
                       (AttentionConfig(8, 8, 32), [33, 1], 0, bf16, 16)]
    paged_dec_cases = [c_ + (gen,) for c_ in paged_dec_cases]
    paged_dec_cases += [(AttentionConfig(2 * g, 2, d7), [keys, 0, keys // 2, keys - 1][:b], 0,
                         f32, BLOCK, more)
                        for keys, b, g in itertools.product(DECODE_KEYS, (1, 4), (1, 4))]
    for attn, lengths, share, dt, bs, src in paged_dec_cases:
        pool, args, (b, kv, g, d) = paged_case(attn, lengths, share, dt, bs, src)
        q, kpg, vpg, tables, lens, kn, vn, max_len = args
        got = ops.paged_decode_attention(*args)
        plain = ops.paged_decode_attention(*args, impl="torch")
        oracle = ref.paged_decode_attention_ref(
            q[:, 0].reshape(b, kv, g, d), kpg, vpg, tables, lens,
            kn.transpose(1, 2), vn.transpose(1, 2)).reshape(b, 1, kv * g, d)
        c.hold(got, plain, oracle, dt, f"lens={lengths} G={g} D={d} bs={bs} "
                                       f"shared={share} {dt}")

    def time_paged(attn, lengths, src=gen):
        pool, args, (b, kv, g, d) = paged_case(attn, lengths, 0, bf16, BLOCK, src)
        q, kpg, vpg, tables, lens, kn, vn, max_len = args
        c.identical(lambda: ops.paged_decode_attention(*args), f"B={b} KV={kv} D={d} (timed)")
        # the yardstick: one SDPA call over each sequence's pages gathered
        # contiguous with its own token at slot len before the timed window,
        # mask kpos <= len
        rows = torch.arange(b, device=cuda)

        def gathered(pages, new):
            got = pages[tables.long()].transpose(1, 2).reshape(b, kv, -1, d)[:, :, :max_len]
            got = got.contiguous()
            got[rows, :, lens.long()] = new[:, 0]
            return got

        kg, vg = gathered(kpg, kn), gathered(vpg, vn)
        qh = q.transpose(1, 2)
        mask = torch.arange(max_len, device=cuda)[None, None, None, :] <= lens[:, None, None, None]

        def sdpa():
            return F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask, enable_gqa=True)

        _, rel = _rel(sdpa().transpose(1, 2), ops.paged_decode_attention(*args))
        log(f"  paged_decode_attention B={b} yardstick (SDPA over pre-gathered K/V) vs kernel "
            f"{rel:.2e}")
        t = {"ms": _time_ms(lambda: ops.paged_decode_attention(*args)),
             "plain_ms": _time_ms(lambda: ops.paged_decode_attention(*args, impl="torch")),
             "library_ms": None,
             "yardstick_ms": _time_ms(sdpa),
             "yardstick": "SDPA over pre-gathered K/V, gather excluded",
             "splits": splits(b, kv, g, tables.shape[1] * BLOCK)}
        split_sweep(t, lambda: ops.paged_decode_attention(*args), b, kv, g,
                    tables.shape[1] * BLOCK)
        keys = sum(lengths)
        pages = sum(-(-n // BLOCK) for n in lengths)
        t["bound_ms"], t["bound_by"] = _bound(
            2 * keys * kv * d * es + 4 * b * kv * g * d * es + 4 * (pages + b),
            4 * d * kv * g * (keys + b))
        return t

    c.timing = time_paged(tgt.attn, main_pos)
    c.timing_b1 = {"llama-7b": time_paged(tgt.attn, [SERIAL_CACHED], more),
                   "llama-1b": time_paged(dft.attn, [SERIAL_CACHED], more)}

    # ---- paged prefill: (C, ctx, KV, G, D, bs, dtype); ctx == 0 gets the
    # dump page; rows tiled over several blocks when C * G > 64; then the
    # edges of the tensor-core tiles: 64-key tiles that straddle the
    # ctx/chunk boundary and ragged last pages, 16-row fragments that mix
    # tokens (G 4, 8)
    c = checks["paged_prefill_attention"]
    chunk = 256
    paged_cases = [(chunk, 0, kvh7, g7, d7, BLOCK, bf16),
                   (max(PROMPT_LENS) - chunk, chunk, kvh7, g7, d7, BLOCK, bf16),
                   (chunk, 0, kvh1, g1, d1, BLOCK, bf16),
                   (max(PROMPT_LENS) - chunk, chunk, kvh1, g1, d1, BLOCK, bf16),
                   (37, 13, 2, 4, 64, 8, f32), (20, 0, 4, 8, 128, 16, f32),
                   (150, 45, 2, 2, 128, 8, f32), (9, 100, 1, 8, 32, 16, bf16)]
    paged_cases += [(cc, ctx, 2, g, d, bs, bf16) for cc, ctx, g, d, bs in itertools.product(
        (1, 16, 17, 65), (0, 1, 15, 16, 63, 64, 65), (1, 4, 8), (80, 128), (8, 16))]
    for cc, ctx, kv, g, d, bs, dt in paged_cases:
        nb = max(-(-ctx // bs), 1)
        nbp = nb + 5
        kpg = torch.full((nbp, kv, bs, d), 1e4, device=cuda).to(dt)
        vpg = torch.full((nbp, kv, bs, d), -1e4, device=cuda).to(dt)
        perm = torch.randperm(nbp - 1, generator=gen, device=cuda)[:nb].to(torch.int32)
        for i, pg in enumerate(perm.tolist()):
            n = min(bs, ctx - i * bs)
            if n > 0:
                kpg[pg, :, :n] = rand(kv, n, d, dtype=dt)
                vpg[pg, :, :n] = rand(kv, n, d, dtype=dt)
        table = perm if ctx else perm[:0]
        q = rand(1, cc, kv * g, d, dtype=dt)
        ks, vs = rand(1, cc, kv, d, dtype=dt), rand(1, cc, kv, d, dtype=dt)
        got = ops.paged_prefill_attention(q, kpg, vpg, table, ctx, ks, vs)
        plain = ops.paged_prefill_attention(q, kpg, vpg, table, ctx, ks, vs, impl="torch")
        tbl = table if ctx else torch.full((1,), nbp - 1, dtype=torch.int32, device=cuda)
        q_tm = q[0].reshape(cc, kv, g, d).permute(1, 0, 2, 3).reshape(kv, cc * g, d)
        oracle = ref.paged_prefill_attention_ref(
            q_tm, kpg, vpg, tbl, ctx, ks[0].transpose(0, 1), vs[0].transpose(0, 1), group=g)
        oracle = oracle.reshape(kv, cc, g, d).permute(1, 0, 2, 3).reshape(1, cc, kv * g, d)
        c.hold(got, plain, oracle, dt, f"C={cc} ctx={ctx} KV={kv} G={g} D={d} bs={bs} {dt}")
        if (cc, ctx, kv) == (max(PROMPT_LENS) - chunk, chunk, kvh7):
            timed = (q, kpg, vpg, table, ctx, ks, vs)
    # the yardstick: one SDPA call over the context gathered contiguous with
    # the chunk's K/V before the timed window, the chunk's offset causality
    # as a boolean mask (key t seen by token i iff t <= ctx + i)
    q, kpg, vpg, table, ctx, ks, vs = timed
    cc, h, d = q.shape[1], q.shape[2], q.shape[3]
    kv = ks.shape[2]

    def gathered(pages, own):
        got = pages[table.long()].transpose(1, 2).reshape(-1, kv, d)[:ctx]
        return torch.cat([got, own[0]]).transpose(0, 1)[None].contiguous()

    kg, vg = gathered(kpg, ks), gathered(vpg, vs)
    qh = q.transpose(1, 2).contiguous()
    mask = (torch.arange(ctx + cc, device=cuda)[None, :]
            <= ctx + torch.arange(cc, device=cuda)[:, None])

    def sdpa():
        return F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask, enable_gqa=True)

    _, rel = _rel(sdpa().transpose(1, 2), ops.paged_prefill_attention(*timed))
    log(f"  paged_prefill_attention yardstick (SDPA over pre-gathered K/V) vs kernel {rel:.2e}")
    c.identical(lambda: ops.paged_prefill_attention(*timed), "(timed)")
    c.timing = {
        "ms": _time_ms(lambda: ops.paged_prefill_attention(*timed)),
        "plain_ms": _time_ms(lambda: ops.paged_prefill_attention(*timed, impl="torch")),
        "library_ms": None,
        "yardstick_ms": _time_ms(sdpa),
        "yardstick": "SDPA over pre-gathered K/V, gather excluded",
    }
    c.timing["bound_ms"], c.timing["bound_by"] = _bound(
        (2 * cc * h * d + 2 * (ctx + cc) * kv * d) * es + 4 * table.shape[0],
        4 * d * h * (cc * ctx + cc * (cc + 1) / 2))
    # ---- the recurrences: (B, T, H, N) / (B, T, H, P, N), dtype, state0;
    # the recurrent phase's prefill and extend shapes, then small ones
    # (T = 1, odd T, one and three heads, state0 zero), then (from the
    # second generator) the edges of the chunked form's chunks: WKV's 16
    # tokens, SSD's KERNEL_CHUNK (half that at N = P = 128)
    def wkv_inputs(b, t, h, n, dt, state, src=gen):
        r, k, v = ((rand(b, t, h, n, g=src) * 0.5).to(dt) for _ in range(3))
        logw = (-torch.exp(rand(b, t, h, n, g=src) * 0.5)).clamp(-8.0, -1e-4)
        s0 = rand(b, h, n, n, g=src) * 0.1 if state else None
        return r, k, v, logw, rand(h, n, g=src) * 0.1, s0

    def ssd_inputs(b, t, h, p, n, dt, state, src=gen):
        x = (rand(b, t, h, p, g=src) * 0.5).to(dt)
        bm, cm = ((rand(b, t, n, g=src) * 0.5).to(dt) for _ in range(2))
        dtv = F.softplus(rand(b, t, h, g=src))
        a_log = torch.log(torch.linspace(1.0, 8.0, h, device=cuda))
        s0 = rand(b, h, n, p, g=src) * 0.1 if state else None
        return x, bm, cm, dtv, a_log, s0

    rwkv, zssm = get_config("rwkv6-7b"), zam.ssm
    hw, nw = rwkv.d_model // rwkv.rwkv.head_dim, rwkv.rwkv.head_dim
    hs = zssm.expand * zam.d_model // zssm.head_dim
    ps, ns = zssm.head_dim, zssm.state_dim
    edges = list(itertools.product((f32, bf16), (True, False)))
    c = checks["rwkv6_wkv"]
    for b, t, h, n, dt, state, src in [
            (REC_BATCH, s_rec, hw, nw, bf16, True, gen), (REC_BATCH, s_rec, hw, nw, f32, True, gen),
            (REC_BATCH, EXTEND, hw, nw, bf16, True, gen), (REC_BATCH, EXTEND, hw, nw, f32, True, gen),
            (1, 1, 1, 64, bf16, True, gen), (2, 16, 3, 64, f32, True, gen),
            (1, 17, 3, 32, bf16, False, gen), (2, 40, 1, 64, f32, True, gen),
            (3, 17, 1, 16, f32, True, gen)] + [
            (2, t, 2, nw, dt, state, more) for t in (wkv.CHUNK - 1, wkv.CHUNK, wkv.CHUNK + 1,
                                                     2 * wkv.CHUNK + 1)
            for dt, state in edges]:
        r, k, v, logw, u, s0 = args = wkv_inputs(b, t, h, n, dt, state, src)
        got = ops.rwkv6_wkv(*args)
        plain = ops.rwkv6_wkv(*args, impl="torch")
        zero = torch.zeros(b, h, n, n, device=cuda)
        oy, os_ = ref.rwkv6_wkv_ref(*(a.transpose(1, 2) for a in (r, k, v, logw)), u,
                                    zero if s0 is None else s0)
        what = f"B={b} T={t} H={h} N={n} state0={state} {dt}"
        c.hold(got[0], plain[0], oy.transpose(1, 2), dt, what + " y")
        c.hold(got[1], plain[1], os_, dt, what + " state")
    args = wkv_inputs(REC_BATCH, s_rec, hw, nw, bf16, True)
    c.identical(lambda: ops.rwkv6_wkv(*args), "(timed)")
    args32 = wkv_inputs(REC_BATCH, s_rec, hw, nw, f32, True, more)
    c.identical(lambda: ops.rwkv6_wkv(*args32), "(fp32 route, path shape)")
    c.timing = {"ms": _time_ms(lambda: ops.rwkv6_wkv(*args)),
                "plain_ms": _time_ms(lambda: ops.rwkv6_wkv(*args, impl="torch")),
                "library_ms": None,
                "fp32_ms": _time_ms(lambda: ops.rwkv6_wkv(*args32))}
    elems = REC_BATCH * s_rec * hw * nw
    c.timing["bound_ms"], c.timing["bound_by"] = _bound(
        3 * elems * es + elems * 4 + hw * nw * 4 + elems * 4 + 2 * REC_BATCH * hw * nw * nw * 4,
        4 * elems * nw)
    c = checks["mamba2_ssd"]
    lc = getattr(ssd, "KERNEL_CHUNK", 64)    # a parent tree's kernel has no chunk
    for b, t, h, p, n, dt, state, src in [
            (REC_BATCH, s_rec, hs, ps, ns, bf16, True, gen),
            (REC_BATCH, s_rec, hs, ps, ns, f32, True, gen),
            (REC_BATCH, EXTEND, hs, ps, ns, bf16, True, gen),
            (REC_BATCH, EXTEND, hs, ps, ns, f32, True, gen),
            (1, 1, 1, 64, 64, bf16, True, gen), (2, 16, 3, 64, 16, f32, True, gen),
            (1, 17, 3, 32, 64, bf16, False, gen), (2, 40, 1, 64, 64, f32, True, gen),
            (3, 17, 1, 16, 128, f32, True, gen)] + [
            (2, t, 2, ps, ns, dt, state, more) for t in (lc - 1, lc, lc + 1, 2 * lc + 1)
            for dt, state in edges] + [
            # N = P = 128: the bf16 route's chunk is half as long there
            (2, t, 2, 128, 128, bf16, state, more) for t in (lc // 2 - 1, lc // 2, lc // 2 + 1,
                                                          lc + 1)
            for state in (True, False)]:
        x, bm, cm, dtv, a_log, s0 = args = ssd_inputs(b, t, h, p, n, dt, state, src)
        got = ops.mamba2_ssd(*args)
        plain = ops.mamba2_ssd(*args, impl="torch")
        zero = torch.zeros(b, h, n, p, device=cuda)
        oy, os_ = ref.mamba2_ssd_ref(x.transpose(1, 2), bm, cm, dtv.transpose(1, 2), a_log,
                                     zero if s0 is None else s0)
        what = f"B={b} T={t} H={h} P={p} N={n} state0={state} {dt}"
        c.hold(got[0], plain[0], oy.transpose(1, 2), dt, what + " y")
        c.hold(got[1], plain[1], os_, dt, what + " state")
    args = ssd_inputs(REC_BATCH, s_rec, hs, ps, ns, bf16, True)
    c.identical(lambda: ops.mamba2_ssd(*args), "(timed)")
    args32 = ssd_inputs(REC_BATCH, s_rec, hs, ps, ns, f32, True, more)
    c.identical(lambda: ops.mamba2_ssd(*args32), "(fp32 route, path shape)")
    c.timing = {"ms": _time_ms(lambda: ops.mamba2_ssd(*args)),
                "plain_ms": _time_ms(lambda: ops.mamba2_ssd(*args, impl="torch")),
                "library_ms": None,
                "fp32_ms": _time_ms(lambda: ops.mamba2_ssd(*args32)),
                "chunks": _ssd_chunk_times(ssd, args)}
    elems, toks = REC_BATCH * s_rec * hs * ps, REC_BATCH * s_rec
    c.timing["bound_ms"], c.timing["bound_by"] = _bound(
        elems * es + 2 * toks * ns * es + toks * hs * 4 + hs * 4 + elems * 4
        + 2 * REC_BATCH * hs * ns * ps * 4,
        4 * elems * ns)

    # the harness's own floor: a one-element kernel, timed as the kernels are
    one = torch.zeros(1, device=cuda)
    print(f"timing floor (ms): a one-element kernel {_time_ms(lambda: one.add_(1)):.4f}, "
          f"the two events around no kernel {_time_ms(lambda: None):.4f}", flush=True)
    for ck in checks.values():
        log(f"{ck.name}: {ck.cases} cases held; kernel {ck.timing['ms']:.4f} ms, "
            f"plain {ck.timing['plain_ms']:.4f} ms, library {ck.timing['library_ms']}, "
            f"bound {ck.timing['bound_ms']:.4f} ms ({ck.timing['bound_by']})")
        print(f"{ck.name}: largest row-normalised error (vs plain, vs fp32 oracle): "
              + ", ".join(f"{k} {p:.3e}, {o:.3e}" for k, (p, o) in sorted(ck.worst.items())),
              flush=True)
        shapes = [("", ck.timing)]
        if ck.timing_d80:
            shapes.append((" at zamba2's head_dim 80 shape", ck.timing_d80))
        shapes += [(f" at one sequence ({k}, {SERIAL_CACHED} cached tokens)", t)
                   for k, t in ck.timing_b1.items()]
        for where, t in shapes:
            print(f"{ck.name}: timed{where} (ms) {_timing_line(t)}", flush=True)
    return checks


def _ssd_chunk_times(ssd, args) -> dict:
    """The SSD kernel's chunked form at each of SSD_CHUNKS tokens a chunk
    (zamba2's N = P = 64 only), through mamba2_ssd_launch_chunk: {chunk:
    device ms}, or {} where this tree's library has no such symbol."""
    import ctypes

    import torch

    from repro_torch.kernels import build

    lib = ctypes.CDLL(str(build._lib_path("mamba2_ssd")))
    if not hasattr(lib, "mamba2_ssd_launch_chunk"):
        return {}
    fn = lib.mamba2_ssd_launch_chunk
    fn.argtypes, fn.restype = ssd.KERNEL.argtypes, ctypes.c_int
    x, bm, cm, dtv, a_log, s0 = args
    b, t, h, p = x.shape
    y = torch.empty(b, t, h, p, device=x.device)
    state = torch.empty(b, h, bm.shape[-1], p, device=x.device)
    stream = build.stream_ptr(x)
    out = {}
    for chunk in SSD_CHUNKS:
        call = (x.data_ptr(), bm.data_ptr(), cm.data_ptr(), dtv.data_ptr(), a_log.data_ptr(),
                s0.data_ptr(), y.data_ptr(), state.data_ptr(), b, t, h, bm.shape[-1], p, chunk,
                stream)
        if fn(*call) != 0:
            raise RuntimeError(f"mamba2_ssd_launch_chunk refused chunk {chunk}")
        want = ssd.mamba2_ssd(*args)
        torch.cuda.synchronize()
        for got, ref_ in zip((y, state), want):     # every chunk computes the same function
            _, rel = _rel(got, ref_)
            if rel > TOL_PLAIN["bfloat16"]["mamba2_ssd"]:
                raise RuntimeError(f"mamba2_ssd at chunk {chunk} disagrees with the "
                                   f"wrapper's: {rel:.3e}")
        out[chunk] = _time_ms(lambda: fn(*call))
    return out


def _timing_line(t) -> str:
    lib = (f"library {t['library_ms']:.4f} (kernel/library "
           f"{_ratio(t['ms'], t['library_ms']):.2f})" if t["library_ms"] else "library None")
    if "yardstick_ms" in t:
        lib += (f", {t['yardstick']} {t['yardstick_ms']:.4f} (kernel/yardstick "
                f"{_ratio(t['ms'], t['yardstick_ms']):.2f})")
    split = ""
    if "splits" in t:
        split = (f"; {t['splits'][0]} splits of {t['splits'][1]} keys" if t["splits"]
                 else "; keys not split (this tree's kernel)")
    for target, (n, chunk, ms) in t.get("per_sm", {}).items():
        split += f"; aimed at {target} blocks an SM: {n} splits of {chunk} keys {ms:.4f}"
    if "fp32_ms" in t:
        split += f"; the fp32 route (per token) {t['fp32_ms']:.4f}"
    for chunk, ms in t.get("chunks", {}).items():
        split += f"; chunk {chunk}: {ms:.4f}"
    return (f"kernel {t['ms']:.4f}, plain {t['plain_ms']:.4f}, {lib}, bound "
            f"{t['bound_ms']:.4f} ({t['bound_by']}, kernel/bound {t['ms'] / t['bound_ms']:.2f})"
            f"{split}")


# ----------------------------------------------------------------- engine
def phase_engine(checks):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.carbon import CHIP_DB, GRID_CI, request_carbon
    from repro_torch.core.spec_decode import SpecConfig
    from repro_torch.models import backbone
    from repro_torch.models.layers import ExecConfig
    from repro_torch.serving.batching import BatchPolicy
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagedKVPool

    cuda = torch.device("cuda")

    def seeded(seed):
        g = torch.Generator(device=cuda)
        g.manual_seed(seed)
        return g

    tcfg, dcfg = get_config("llama-7b"), get_config("llama-1b")
    t = time.perf_counter()
    tparams = backbone.init_params(seeded(0), tcfg)
    dparams = backbone.init_params(seeded(1), dcfg)
    torch.cuda.synchronize()
    log(f"init: {time.perf_counter() - t:.1f} s for {tcfg.name} + {dcfg.name} (bf16, full width)")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]
    pool_blocks = sum(-(-(n + MAX_NEW + 8) // BLOCK) for n in PROMPT_LENS) + 16
    runs = [("standalone", "serialized", True), ("standalone", "serialized", False),
            ("standalone", "continuous", True), ("dpd", "continuous", True),
            ("spec", "serialized", "auto"), ("dsd", "continuous", "auto")]

    def serve(kind, policy, paged, exec_cfg=ExecConfig()):
        """One engine run over the prompts; (engine, finished, wall s)."""
        kw = {"exec_cfg": exec_cfg}
        if kind in ("spec", "dsd"):
            kw.update(draft_cfg=dcfg, draft_params=dparams, spec=SpecConfig(num_draft_tokens=4))
        if kind in ("dpd", "dsd"):
            kw["old_chip"] = "t4"
        batching = BatchPolicy(block_size=BLOCK) if policy == "continuous" else "serialized"
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng = ServingEngine(tcfg, tparams, kind=kind, new_chip="a100", temperature=0.0,
                            seed=0, max_batch=8, pool_blocks=pool_blocks, block_size=BLOCK,
                            batching=batching, paged=paged, device=cuda, **kw)
        for p in prompts:
            eng.submit(p, MAX_NEW, arrival_s=0.0)
        done = eng.run_until_idle()
        torch.cuda.synchronize()
        return eng, done, time.perf_counter() - t

    for ck in checks.values():
        ck.kernel.launches = 0
    streams, walls = {}, {}
    for kind, policy, paged in runs:
        before = {n: ck.kernel.launches for n, ck in checks.items()}
        eng, done, wall = serve(kind, policy, paged)
        streams[f"{kind}/{policy}/paged={paged}"] = [
            r.out_tokens for r in sorted(done, key=lambda r: r.req_id)]
        walls[f"{kind}/{policy}/paged={paged}"] = [wall]
        if len(done) != len(prompts) or any(
                len(r.out_tokens) != MAX_NEW or r.status != "ok" for r in done):
            raise RuntimeError(f"{kind}/{policy}: requests did not all finish with "
                               f"{MAX_NEW} tokens: {[len(r.out_tokens) for r in done]}")
        if eng.paged and kind in ("standalone", "dpd") and eng.pool.gather_calls:
            raise RuntimeError(f"{kind}/{policy}: paged run gathered "
                               f"{eng.pool.gather_calls} times")
        used = {n: ck.kernel.launches - before[n] for n, ck in checks.items()}
        # the greedy streams, in submission order, as one digest: two
        # versions of the kernels that serve the same tokens print the same
        tokens = [t for r in sorted(done, key=lambda r: r.req_id) for t in r.out_tokens]
        digest = hashlib.sha1(np.asarray(tokens, dtype=np.int64).tobytes()).hexdigest()[:12]
        ci = GRID_CI["ciso"]
        carbon = sum((request_carbon(u.busy_s, u.energy_j, CHIP_DB[n], ci_g_per_kwh=ci).total_g
                      for n, u in eng.use.items()))
        print(f"engine {kind:10s} {policy:10s} paged={str(eng.paged):5s} wall {wall:.2f} s "
              f"on this card; cost model ({'+'.join(eng.use)}, not measured): clock "
              f"{eng.clock:.4f} s, {carbon * 1e3:.4f} mgCO2; streams {digest}; launches {used}",
              flush=True)
        if eng.rounds:
            log(f"  spec acceptance {eng.acceptance_rate:.3f} over {eng.rounds} rounds")
        del eng
        torch.cuda.empty_cache()
    for ck in checks.values():
        ck.path_launches += ck.kernel.launches
    # the host sets the engine's pace, and one run's wall time varies by tens
    # of percent: two more runs of each kind (after the counted ones, so the
    # launch counts stay those of one run each) give three walls to compare
    for (kind, policy, paged), name in zip(runs, walls):
        for _ in range(2):
            walls[name].append(serve(kind, policy, paged)[2])
            torch.cuda.empty_cache()
    print("engine walls (s), three runs of each kind: " + "; ".join(
        f"{name} {', '.join(f'{w:.2f}' for w in ws)} (median {sorted(ws)[1]:.2f})"
        for name, ws in walls.items()), flush=True)

    # each run's greedy streams against the plain path's (impl="torch", no
    # kernel) on the card: the tokens a run shares with it before each
    # request's first divergence. With random weights many steps are near
    # ties, so any change in rounding can flip one and the rest of that
    # stream follows; this is read, not held to a limit
    _, done, _ = serve("standalone", "serialized", True, ExecConfig(impl="torch"))
    want = [r.out_tokens for r in sorted(done, key=lambda r: r.req_id)]
    agree = {run: sum(_common_prefix(a, b) for a, b in zip(got, want))
             for run, got in streams.items()}
    print(f"engine streams vs the plain path (standalone/serialized/paged=True, impl=torch), "
          f"tokens before each request's first divergence, of {len(prompts) * MAX_NEW}: "
          f"{agree}", flush=True)

    # first-token logits, kernel path vs the plain path, on the card, for the
    # target and the draft: whole-prompt prefill (flash) and a two-chunk
    # paged prefill (paged prefill)
    plain = ExecConfig(impl="torch")
    tok = torch.from_numpy(prompts[-1]).to(cuda)
    for cfg, params in ((tcfg, tparams), (dcfg, dparams)):
        got, _ = backbone.prefill(params, {"tokens": tok[None]}, cfg)
        want, _ = backbone.prefill(params, {"tokens": tok[None]}, cfg, plain)
        chunked = []
        for ex in (ExecConfig(), plain):
            pool = PagedKVPool(cfg, pool_blocks, BLOCK, dtype=torch.bfloat16, device=cuda)
            pool.allocate(0, len(tok))
            ctx0 = 256
            for lo, hi in ((0, ctx0), (ctx0, len(tok))):
                table = pool.device_tables([0], max(pool.blocks_needed(lo), 1))[0]
                logits, kc, vc = backbone.prefill_chunk_paged(
                    params, pool.k, pool.v, table, lo, tok[lo:hi], cfg, ex)
                pool.scatter_chunk(0, kc, vc, lo)
            chunked.append(logits)
            del pool
        for what, a, b in ((f"{cfg.name} prefill", got, want),
                           (f"{cfg.name} chunked prefill", *chunked)):
            if not (torch.isfinite(a.float()).all() and torch.isfinite(b.float()).all()):
                raise RuntimeError(f"{what}: non-finite first-token logits")
            _, rel = _rel(a, b)
            cos = torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min()
            print(f"first-token logits, {what}: kernel vs plain on the card {rel:.3e} "
                  f"(row-normalised, tol {TOL_LOGITS:g}), cosine {float(cos):.6f}; "
                  f"argmax {int(a.argmax())} vs {int(b.argmax())}", flush=True)
            if rel > TOL_LOGITS:
                raise RuntimeError(f"{what}: kernel path logits disagree ({rel:.3e})")

    # where one run's time goes: device busy share and the top kernels, from
    # torch.profiler over the standalone continuous paged run
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall = serve("standalone", "continuous", True)
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in on_card)
    print(f"profile standalone continuous paged: wall {wall:.3f} s with the profiler "
          f"on, device busy {busy_us / 1e6:.3f} s = {busy_us / 1e6 / wall:.1%} of wall",
          flush=True)
    for e in sorted(on_card, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}",
              flush=True)
    _print_port_kernels(on_card)


# -------------------------------------------------------------- recurrent
def phase_recurrent(checks, card):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import backbone
    from repro_torch.models.layers import ExecConfig

    cuda = torch.device("cuda")
    plain = ExecConfig(impl="torch")
    rng = np.random.default_rng(1)
    b, s = REC_BATCH, max(PROMPT_LENS)
    for arch in REC_ARCHS:
        cfg = get_config(arch)
        gen = torch.Generator(device=cuda)
        gen.manual_seed(2)
        t = time.perf_counter()
        params = backbone.init_params(gen, cfg)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in _leaves(params))
        log(f"init: {time.perf_counter() - t:.1f} s for {arch} ({n_params / 1e9:.2f} B params, "
            f"bf16, full width)")
        L = cfg.num_layers
        if cfg.family == "ssm":
            per = {"prefill": {"rwkv6_wkv": L}, "step": {}, "extend": {"rwkv6_wkv": L}}
        else:
            taps = L // cfg.hybrid_attn_every
            per = {"prefill": {"mamba2_ssd": L, "flash_attention": taps},
                   "step": {"decode_attention": taps}, "extend": {"mamba2_ssd": L}}

        def counted(what, want, fn):
            """Run fn, synchronise, and hold the kernels it launched to
            exactly `want`; returns (result, wall seconds)."""
            before = {n: ck.kernel.launches for n, ck in checks.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            used = {n: ck.kernel.launches - before[n] for n, ck in checks.items()}
            expected = {n: want.get(n, 0) for n in checks}
            if used != expected:
                raise RuntimeError(f"{arch} {what}: launches {used}, expected {expected}")
            return out, secs

        def finite(what, logits):
            if not torch.isfinite(logits.float()).all():
                raise RuntimeError(f"{arch} {what}: non-finite logits")

        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s))).to(cuda)
        for ck in checks.values():
            ck.kernel.launches = 0
        (first, cache), prefill_s = counted(
            "prefill", per["prefill"], lambda: backbone.prefill(params, {"tokens": tokens}, cfg))
        finite("prefill", first)
        cache = backbone._grow_cache(cache, cfg, s + MAX_NEW + EXTEND)
        tok, step_s = first.argmax(-1), []
        for i in range(MAX_NEW):
            (logits, cache), secs = counted(
                f"serve_step {i}", per["step"],
                lambda: backbone.serve_step(params, cache, tok, cfg))
            finite(f"serve_step {i}", logits)
            step_s.append(secs)
            tok = logits.argmax(-1)
        # extend_step of EXTEND greedy tokens from a saved cache, against
        # EXTEND serve_steps from the same cache (both write K/V in place, so
        # each starts from its own copy)
        saved = _clone(cache)
        ext_tok, step_logits = [], []
        for i in range(EXTEND):
            ext_tok.append(tok)
            (logits, cache), _ = counted(
                f"serve_step {MAX_NEW + i}", per["step"],
                lambda: backbone.serve_step(params, cache, tok, cfg))
            step_logits.append(logits)
            tok = logits.argmax(-1)
        ext_tok = torch.stack(ext_tok, 1)
        (ext_logits, ext_cache), ext_s = counted(
            "extend_step", per["extend"],
            lambda: backbone.extend_step(params, _clone(saved), ext_tok, cfg))
        finite("extend_step", ext_logits)
        for ck in checks.values():
            ck.path_launches += ck.kernel.launches
        print(f"recurrent {arch}: prefill {b}x{s} tokens {prefill_s:.3f} s wall, decode "
              f"{np.mean(step_s) * 1e3:.1f} ms per step (min {min(step_s) * 1e3:.1f}, max "
              f"{max(step_s) * 1e3:.1f}) over {MAX_NEW} greedy serve_steps, extend_step of "
              f"{EXTEND} tokens {ext_s * 1e3:.1f} ms; host clock on {card}", flush=True)
        # the same check on the plain path (which launches no kernel): the
        # bf16 divergence between a 4-token chunk and 4 single tokens is the
        # model's, not the kernels'
        state_key = "state" if cfg.family == "ssm" else "ssm_state"
        pc, plain_logits = _clone(saved), []
        for i in range(EXTEND):
            (logits, pc), _ = counted(f"plain serve_step {i}", {}, lambda: backbone.serve_step(
                params, pc, ext_tok[:, i], cfg, plain))
            plain_logits.append(logits)
        (pext_logits, pext_cache), _ = counted(
            "plain extend_step", {},
            lambda: backbone.extend_step(params, _clone(saved), ext_tok, cfg, plain))
        errs = {}
        for path, (el, ec, sl, sc) in {
                "kernel": (ext_logits, ext_cache, step_logits, cache),
                "plain": (pext_logits, pext_cache, plain_logits, pc)}.items():
            # the final recurrent state as max|a - b| / max|b|: a state row
            # can decay to ~0, so a row-normalised figure says nothing there
            abs_err, _ = _rel(ec[state_key], sc[state_key])
            errs[path] = (max(_rel(el[:, i], sl[i])[1] for i in range(EXTEND)),
                          abs_err / sc[state_key].abs().max().item())
        print(f"recurrent {arch}: extend_step vs {EXTEND} serve_steps from the same cache, "
              f"logits (row-normalised) kernel path {errs['kernel'][0]:.3e} (tol "
              f"{TOL_EXTEND:g}), plain path {errs['plain'][0]:.3e}; final {state_key} "
              f"(max|d| / max|ref|) {errs['kernel'][1]:.3e}, {errs['plain'][1]:.3e}", flush=True)
        if errs["kernel"][0] > TOL_EXTEND:
            raise RuntimeError(f"{arch}: extend_step disagrees with serve_steps "
                               f"({errs['kernel'][0]:.3e})")
        # first-token logits, kernel path vs the plain path on the card
        want, _ = backbone.prefill(params, {"tokens": tokens}, cfg, plain)
        finite("plain prefill", want)
        abs_err, rel = _rel(first, want)
        cos = torch.nn.functional.cosine_similarity(first.float(), want.float(), dim=-1).min()
        got_arg, want_arg = first.argmax(-1), want.argmax(-1)
        # a differing argmax is a disagreement unless the plain path's two
        # candidates lie within the observed error of each other (a tie)
        rows = torch.arange(b, device=cuda)
        gap = (want[rows, want_arg] - want[rows, got_arg]).float().abs().max().item()
        tie = (f" (differing rows: the plain path's two candidates {gap:.4f} apart, within "
               f"the largest error {abs_err:.4f}: a tie)" if gap else "")
        print(f"first-token logits, {arch} prefill: kernel vs plain on the card {rel:.3e} "
              f"(row-normalised, tol {TOL_LOGITS_REC:g}), cosine {float(cos):.6f}; argmax "
              f"{got_arg.tolist()} vs {want_arg.tolist()}{tie}", flush=True)
        if rel > TOL_LOGITS_REC or gap > abs_err:
            raise RuntimeError(f"{arch}: kernel path logits disagree ({rel:.3e}, argmax "
                               f"{got_arg.tolist()} vs {want_arg.tolist()})")
        floor = _plain_half_chunk(lambda: backbone.prefill(params, {"tokens": tokens}, cfg,
                                                            plain)[0])
        _, rel_floor = _rel(floor, want)
        cos_floor = torch.nn.functional.cosine_similarity(
            floor.float(), want.float(), dim=-1).min()
        print(f"first-token logits, {arch} prefill: noise floor (plain path with the "
              f"recurrence's chunk halved vs plain path) {rel_floor:.3e}, cosine "
              f"{float(cos_floor):.6f}; argmax {floor.argmax(-1).tolist()}", flush=True)
        # where a prefill and the decode steps spend their time
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, pc = backbone.prefill(params, {"tokens": tokens}, cfg)
            pc = backbone._grow_cache(pc, cfg, s + EXTEND)
            for _ in range(EXTEND):
                logits, pc = backbone.serve_step(params, pc, logits.argmax(-1), cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.device_time_total for e in on_card)
        print(f"profile {arch} prefill + {EXTEND} serve_steps: wall {wall:.3f} s with the "
              f"profiler on, device busy {busy_us / 1e6:.3f} s = {busy_us / 1e6 / wall:.1%} of "
              f"wall", flush=True)
        for e in sorted(on_card, key=lambda e: -e.device_time_total)[:8]:
            print(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}",
                  flush=True)
        _print_port_kernels(on_card)
        del params, cache, saved, ext_cache, pc
        torch.cuda.empty_cache()


def _print_port_kernels(on_card) -> None:
    """The profile's rows of the port's own kernels (the `*_kernel`
    functions of the imported package's csrc/, each in its source's
    anonymous namespace): device ms, launches, ms a launch."""
    import re

    from repro_torch.kernels import build

    # the sources of the package this run imported (a --tree run's own)
    names = {n for f in build.CSRC.glob("*.cu")
             for n in re.findall(r"(\w+_kernel)\(", f.read_text())}
    for e in sorted(on_card, key=lambda e: -e.device_time_total):
        if not e.key.startswith("void (anonymous namespace)::"):
            continue
        name = e.key.split("::", 1)[1].split("(", 1)[0]
        if name.split("<", 1)[0] in names:
            print(f"  port kernel {name}: {e.device_time_total / 1e3:.3f} ms over {e.count} "
                  f"launches, {e.device_time_total / 1e3 / e.count:.4f} ms each", flush=True)


def _plain_half_chunk(fn):
    """Run fn with the plain WKV and SSD versions at half their chunk: the
    same functions in another fp32 summation order."""
    from unittest import mock

    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv

    wkv_plain, ssd_math = wkv.wkv_chunked_plain, ssd.ssd_chunked_math

    # the chunked forms pad T by calling themselves by module name with the
    # chunk as the last positional argument: that call lands here too
    def wkv_half(r, k, v, logw, u, state0=None, chunk=None):
        return wkv_plain(r, k, v, logw, u, state0, wkv.CHUNK // 2)

    def ssd_half(xh, b_in, c_in, dt, a_log, state0=None, chunk=None):
        return ssd_math(xh, b_in, c_in, dt, a_log, state0, ssd.CHUNK // 2)

    with mock.patch.object(wkv, "wkv_chunked_plain", wkv_half), \
            mock.patch.object(ssd, "ssd_chunked_math", ssd_half):
        return fn()


def _common_prefix(a, b) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def _clone(cache: dict) -> dict:
    return {k: v.clone() for k, v in cache.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def main(argv: list[str]) -> int:
    import torch

    # --tree DIR: every phase over the port's package in DIR/src (another
    # checkout, e.g. a parent commit unpacked with `git archive`), so that
    # two versions are held, timed and profiled by one harness in one call;
    # skips the SASS and spill checks (an older tree's kernels had no
    # tensor-core or cp.async route) and prints no result line
    other = pathlib.Path(argv[argv.index("--tree") + 1]).resolve() if "--tree" in argv else None
    if other is not None:
        sys.path.insert(0, str(other / "src"))
    t0 = time.perf_counter()
    card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}", flush=True)
    logs = phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if other is None:
        phase_sass(logs)
    checks = phase_kernels(gen)
    phase_engine(checks)
    torch.cuda.empty_cache()
    phase_recurrent(checks, card)
    idle = [n for n, ck in checks.items() if ck.path_launches == 0]
    if idle:
        raise RuntimeError(f"kernels never launched on a path: {idle}")
    log(f"total {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if other is not None:
        print(f"tree {other}: every phase passed on {card}", flush=True)
        return 0
    print(card)
    print(json.dumps({"kernels": [ck.record() for ck in checks.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
