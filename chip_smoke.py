#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
H100 and check them.

    python3 chip_smoke.py        # from the root of a checkout; needs one card
    python3 chip_smoke.py --tree DIR   # the same phases over the port's package
                                 # in DIR/src (a parent commit), no result line

Phases; any failure raises, and the script then exits non-zero and prints
no result:

  device   CUDA present with capability 9.0; the card's name and power limit
           from nvidia-smi.
  build    nvcc builds every kernel from src/repro_torch/csrc (one process
           per source, all at once) and prints each kernel's registers and
           spills (-Xptxas=-v), read from the ptxas log saved beside each
           library, whether built now or cached (a cached library without
           its log fails the phase: delete it and rebuild); the tensor-core
           kernels must not spill at head_dim 128, the SASS of the two
           prefill kernels and of the two
           recurrences must hold HMMA (tensor-core) and LDGSTS (cp.async)
           instructions, that of the two decode kernels LDGSTS, the decodes'
           path instantiations (bf16, one query row a kv head, head_dim 128
           and 80; the dense decode also at 8 rows a kv head and head_dim 64,
           for the families phase) must not spill, and no instantiation of the two
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
           with the decodes' split of the keys printed for each, and the
           dense decode held and timed at the families' decode shapes
           (qwen2-vl-72b's G 8, musicgen-medium's head_dim 64); the paged
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
  families qwen2-moe-a2.7b (moe) at full width and depth (bf16, seeded
           random weights, 24 layers, 60 experts top-4 plus the shared one)
           through ServingEngine over the engine phase's prompts: standalone
           serialized paged and dense, standalone continuous paged, dpd
           continuous; launches held exactly to 24 flash a prefill pass and
           24 paged (or dense) decodes a step, no gather on a paged run;
           first-token logits of the kernel path against the plain path
           beside their noise floor and the routing choices each flips; a
           profile of one continuous run. Then qwen2-vl-72b (vlm, full width,
           16 of its 80 layers) on 4 x 451 patch embeddings at three M-RoPE
           streams (a text prefix, then a 21 x 21 patch grid) and
           musicgen-medium (audio, full width and depth) on 4 x 451 frame
           embeddings, each through prefill, 16 greedy serve_steps
           (musicgen's fed seeded frames) and an extend_step of 4 tokens
           from the saved cache held against 4 serve_steps, launches exact
           (flash a layer a prefill, dense decode a layer a step), and
           first-token logits against the plain path. Under --tree, a tree
           without the MoE prints "families: not in this tree".
  planning the paper's planning stack on the host (numpy, no JAX): the
           main() of examples/torch_{serve_disaggregated, carbon_planner,
           fleet_allocate, autoscale}.py at the reference examples' scale
           (9 configs over llama-7b with llama-1b / llama-300m drafts, a100
           new, t4 / v100 old; 12 workloads, 60 s windows, 70% profiled; the
           fleet allocation and the diurnal autoscale), printed with each
           one's host seconds; Algorithm 1's contract on the scheduler's
           decisions over the matrices completed by collaborative filtering
           (every workload decided; a feasible decision meets the SLO
           target at the least carbon among the feasible configs, an
           infeasible one has the best SLO attainment; the example printed
           that table); and one VectorFleetSim drain in scale mode, 1000
           replicas x 100k sharegpt requests, which must finish every
           request with exactly its output tokens. Under --tree, a tree
           without the planning stack prints "planning: not in this tree".
  training the port's training path, which reaches no kernel (the reference
           trains with use_kernels=False, and no kernel has a backward): the
           kernels' front door must refuse a CUDA input that requires a
           gradient. llama-7b at full width, 12 of its 32 layers (2.69 B
           params; bf16 weights from the port's seeded init, batches from
           data.synthetic_batch, 4 x 1024 tokens): (a) step 1's loss and
           gradient norm against the same model upcast to fp32, beside the
           bf16 noise floor (query rows in blocks of half the sequence);
           (b) microbatches=2 against 1; (c) six AdamW train_steps over one
           batch must lower the loss; (d) peak device memory within the
           reckoning of 16 B a param plus an allowance; (e) step ms (median
           of steps 2-6), tokens/s, model-FLOPs share of 989e12 and the
           device-busy share of one profiled step. Then one train_step each,
           with its loss and gradient norm against an fp32 copy, of
           qwen2-moe-a2.7b (2 of 24 layers, 60 experts), rwkv6-7b (2 layers),
           zamba2-2.7b (6 layers, one shared-attention tap) and
           musicgen-medium (all 48, on frame embeddings); qwen2-vl-72b is
           left to the CPU tests (its embedding and head alone are 2.49 B
           params, ~40 GB of training state). Through a one-rank nccl group:
           make_sharded_train_step on a (1, 1) mesh against train_step (for
           llama-300m, and for qwen2-moe-a2.7b (2 layers) with the
           sequence-parallel carry and ep_axes=("data",), whose all-to-all
           is then an identity but runs over nccl), the compressed step, and `launch.train --arch llama-300m --full` (12
           steps, a checkpoint every 6 under build/train_ckpt, removed after)
           whose step-6 checkpoint a second trainer restores: it must print
           the launcher's losses for steps 7-12, and its final state is
           compared with the launcher's bit for bit. Every kernel's launch
           count must not move over the phase. Under --tree, a tree without
           training prints "training: not in this tree".
  dryrun   repro_torch.launch.dryrun on the host, over fake process groups
           (nothing allocated; meta tensors as DTensors): full-depth proof
           cells (llama-7b, qwen2-moe-a2.7b and llama4-scout-17b-a16e
           train_4k on the (16, 16) pod, sequence-parallel, llama4-scout's
           16 experts expert-parallel over "data"; zamba2-2.7b long_500k on
           the (2, 16, 16) multi-pod mesh, musicgen-medium decode_32k), each
           record printed with its host seconds and its seq_parallel and
           expert_parallel_dispatch; qwen2-moe's train cell must fit the
           card's memory; its prediction for the training phase's own cell (one
           AdamW step on a (1, 1) mesh) beside what the card measured there:
           peak bytes against max_memory_allocated (within DRYRUN_PEAK) and
           counted FLOPs against the model-FLOPs formula; kernels/smem.py
           held == to every library's own report of its launch
           configuration (dynamic and static shared bytes, threads, and a
           register count that fits an SM) at every instantiation its
           launchers reach. Under --tree, a tree without the dry-run prints
           "dryrun: not in this tree".
After all path phases every kernel must have launched on a path.

The engine's modelled clock, energy and carbon are the cost model's figures
for the chips it names (a100 new, t4 old), not measurements of this card.
The last lines of standard output are: the nvidia-smi line, one JSON object
{"kernels": [...]}, and {"ok": true, "device": {...}}. The launches there
are the sums over the path phases (engine, recurrent and families).
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
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
#   adds one attention output's bf16 difference (largest reading 9.4e-2;
#   qwen2-vl-72b at 16 layers 9.9e-2, musicgen-medium 8.9e-2, PR 17)
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
#   qwen2-moe-a2.7b's first-token logits, kernel path vs plain path, both
#   bf16: a bf16 difference in one layer's attention output can flip a top-4
#   routing choice in a later layer, and a flipped choice moves the logits
#   far more than the attention difference itself. The phase measures the
#   noise floor: the plain path against itself with its query rows in two
#   blocks (another summation order), and prints the routing choices each
#   reading flips. Largest reading 3.1e-1 (3529 of 43296 routing choices
#   differ), the noise floor 1.7e-1 (1653 differ) (PERF.md, PR 17)
TOL_LOGITS_MOE = 1.0

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
# the families phase: qwen2-moe-a2.7b through the engine (the engine phase's
# prompts), qwen2-vl-72b at full width with its depth cut to fit the card
# beside nothing else, and musicgen-medium, both through the backbone at the
# recurrent phase's batch (4 x 451 embeddings; qwen2-vl's a text prefix of
# VL_TEXT tokens, then a 21 x 21 grid of patches)
MOE_ARCH = "qwen2-moe-a2.7b"
VL_ARCH, VL_LAYERS, VL_TEXT = "qwen2-vl-72b", 16, 10
AUDIO_ARCH = "musicgen-medium"


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
    """Build every kernel; returns {source: ptxas log} for every library,
    built now or cached: a cached library's log is the one saved beside it
    when it was built, and a cached library without one fails the phase."""
    from repro_torch.kernels import build

    t = time.perf_counter()
    built = build.build_all()
    secs = time.perf_counter() - t
    print(f"build: {secs:.1f} s for {len(built)} sources "
          f"({', '.join(built) or 'none'}); cached: "
          f"{', '.join(s for s in build.SOURCES if s not in built) or 'none'}", flush=True)
    if hasattr(build, "ptxas_log"):
        logs = {src: build.ptxas_log(src) for src in build.SOURCES}
    else:       # a --tree checkout from before the logs were saved
        logs = built
    for src, out in logs.items():
        for kernel, regs, spills in _ptxas_kernels(out):
            print(f"ptxas {src} {kernel}: {regs} registers, {spills}", flush=True)
            if kernel.endswith("mma_kernel<128>") and not spills.startswith("0 bytes spill stores"):
                raise RuntimeError(f"{src} {kernel} spills at head_dim 128: {spills}")
    return logs


# the decode kernels' instantiations on the serving paths: bf16, one query
# row a kv head (G = 1), llama's and qwen2-moe's head_dim 128 and zamba2's 80;
# the dense decode also at qwen2-vl-72b's G 8 (8 rows a block) and
# musicgen-medium's head_dim 64
DECODE_PATH = {"decode_attention": ("decode_kernel<bf16,128,1>", "decode_kernel<bf16,80,1>",
                                    "decode_kernel<bf16,128,8>", "decode_kernel<bf16,64,1>"),
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
        spills = {k: sp for k, _, sp in _ptxas_kernels(logs[src])}
        for inst in insts:
            if spills.get(inst) != NO_SPILL:
                raise RuntimeError(f"{src} {inst} spills or is missing: {spills.get(inst)}")
        print(f"ptxas {src}: the path instantiations {', '.join(insts)} do not spill",
              flush=True)
    for src, insts in REC_PATH.items():
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
        self.timing_fam = {}         # the decode at the families' shapes: label -> timing
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
        if self.timing_fam:
            rec["families"] = {k: dict(v, library_ratio=_ratio(v["ms"], v["library_ms"]))
                               for k, v in self.timing_fam.items()}
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
    # the two instantiations the families phase brings to a serving path:
    # qwen2-vl-72b's 8 query heads a kv head (decode_kernel<bf16,128,8>) and
    # musicgen-medium's head_dim 64 (<bf16,64,1>), held at that phase's decode
    # shapes (ragged and mid-decode) and timed mid-decode; from a generator of
    # their own, so every earlier case keeps its inputs
    fam = torch.Generator(device=cuda)
    fam.manual_seed(2)
    fam_pos = [s_rec + MAX_NEW // 2] * REC_BATCH
    for arch in (VL_ARCH, AUDIO_ARCH):
        a = get_config(arch).attn
        kv, g, d = a.num_kv_heads, a.num_heads // a.num_kv_heads, a.head_dim
        for pos in (rec_pos, fam_pos):
            b = len(pos)
            q = rand(b, 1, kv * g, d, dtype=bf16, g=fam)
            kc, vc = rand(b, kv, rec_slots, d, dtype=bf16, g=fam), rand(b, kv, rec_slots, d,
                                                                         dtype=bf16, g=fam)
            p = ints(pos)
            oracle = ref.decode_attention_ref(q[:, 0].reshape(b, kv, g, d), kc, vc, p)
            c.hold(ops.decode_attention(q, kc, vc, p),
                   ops.decode_attention(q, kc, vc, p, impl="torch"),
                   oracle.reshape(b, 1, kv * g, d), bf16,
                   f"{arch} B={b} KV={kv} G={g} S={rec_slots} D={d} pos={pos} bf16")
        c.timing_fam[f"{arch} (G {g}, D {d})"] = time_dense(REC_BATCH, kv, g, d, fam_pos,
                                                            rec_slots, src=fam)

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
        shapes += [(f" at {k}'s decode, {REC_BATCH} sequences of {s_rec + MAX_NEW // 2} "
                    "cached tokens", t) for k, t in ck.timing_fam.items()]
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
    streams = {}
    for kind, policy, paged in runs:
        before = {n: ck.kernel.launches for n, ck in checks.items()}
        eng, done, wall = serve(kind, policy, paged)
        streams[f"{kind}/{policy}/paged={paged}"] = [
            r.out_tokens for r in sorted(done, key=lambda r: r.req_id)]
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
            return _counted(checks, f"{arch} {what}", want, fn)

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


def _counted(checks, what, want, fn):
    """Run fn, synchronise, and hold the kernels it launched to exactly
    `want` ({kernel: launches}, the rest 0); returns (result, wall s)."""
    import torch

    before = {n: ck.kernel.launches for n, ck in checks.items()}
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    used = {n: ck.kernel.launches - before[n] for n, ck in checks.items()}
    expected = {n: want.get(n, 0) for n in checks}
    if used != expected:
        raise RuntimeError(f"{what}: launches {used}, expected {expected}")
    return out, secs


# --------------------------------------------------------------- families
def phase_families(checks, card):
    """The moe family through ServingEngine at qwen2-moe-a2.7b's full width
    and depth, then the vlm and audio families through the backbone."""
    import torch

    _serve_moe(checks, card)
    torch.cuda.empty_cache()
    for arch in (VL_ARCH, AUDIO_ARCH):
        _frontend_model(checks, card, arch)
        torch.cuda.empty_cache()


def _serve_moe(checks, card):
    import numpy as np
    import torch
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import backbone
    from repro_torch.models.layers import ExecConfig
    from repro_torch.serving.batching import BatchPolicy
    from repro_torch.serving.engine import ServingEngine

    cuda = torch.device("cuda")
    cfg = get_config(MOE_ARCH)
    L, m = cfg.num_layers, cfg.moe
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    t = time.perf_counter()
    params = backbone.init_params(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"init: {time.perf_counter() - t:.1f} s for {MOE_ARCH} ({n_params / 1e9:.2f} B params, "
        f"bf16, full width and depth)")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]
    pool_blocks = sum(-(-(n + MAX_NEW + 8) // BLOCK) for n in PROMPT_LENS) + 16

    def serve(kind, policy, paged):
        """One engine run over the prompts; (engine, finished, wall s)."""
        batching = BatchPolicy(block_size=BLOCK) if policy == "continuous" else "serialized"
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng = ServingEngine(cfg, params, kind=kind, new_chip="a100",
                            old_chip="t4" if kind == "dpd" else None, temperature=0.0,
                            seed=0, max_batch=8, pool_blocks=pool_blocks, block_size=BLOCK,
                            batching=batching, paged=paged, device=cuda)
        for p in prompts:
            eng.submit(p, MAX_NEW, arrival_s=0.0)
        done = eng.run_until_idle()
        torch.cuda.synchronize()
        return eng, done, time.perf_counter() - t

    # the backbone passes each run makes, counted (and each decode step timed
    # on the host clock between two synchronisations) by wrapping the entry
    # points the engine calls
    calls, step_s = {}, []

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            if name == "prefill":
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            return out
        return wrapped

    runs = [("standalone", "serialized", True), ("standalone", "serialized", False),
            ("standalone", "continuous", True), ("dpd", "continuous", True)]
    steps = {}
    for kind, policy, paged in runs:
        name = f"{kind}/{policy}/paged={paged}"
        calls.clear()
        step_s.clear()
        for ck in checks.values():
            ck.kernel.launches = 0
        with mock.patch.object(backbone, "prefill", counting("prefill", backbone.prefill)), \
                mock.patch.object(backbone, "serve_step_paged",
                                  counting("paged", backbone.serve_step_paged)), \
                mock.patch.object(backbone, "serve_step", counting("dense", backbone.serve_step)):
            eng, done, wall = serve(kind, policy, paged)
        used = {n: ck.kernel.launches for n, ck in checks.items()}
        for ck in checks.values():
            ck.path_launches += ck.kernel.launches
        want = {n: 0 for n in checks}
        want.update(flash_attention=L * calls.get("prefill", 0),
                    paged_decode_attention=L * calls.get("paged", 0),
                    decode_attention=L * calls.get("dense", 0))
        if used != want or not calls.get("prefill") or not calls.get("paged" if paged else "dense"):
            raise RuntimeError(f"{MOE_ARCH} {name}: launches {used}, expected {want} for "
                               f"backbone passes {calls}")
        if eng.paged is not paged or (paged and eng.pool.gather_calls):
            raise RuntimeError(f"{MOE_ARCH} {name}: paged={eng.paged}, "
                               f"{eng.pool.gather_calls} gathers")
        if len(done) != len(prompts) or any(
                len(r.out_tokens) != MAX_NEW or r.status != "ok" for r in done):
            raise RuntimeError(f"{MOE_ARCH} {name}: requests did not all finish with "
                               f"{MAX_NEW} tokens: {[len(r.out_tokens) for r in done]}")
        tokens = [t for r in sorted(done, key=lambda r: r.req_id) for t in r.out_tokens]
        digest = hashlib.sha1(np.asarray(tokens, dtype=np.int64).tobytes()).hexdigest()[:12]
        steps[name] = sorted(step_s)
        print(f"families {MOE_ARCH} {kind:10s} {policy:10s} paged={str(paged):5s} wall "
              f"{wall:.2f} s on this card; backbone passes {calls}; decode step (ms, host clock "
              f"between synchronisations) median {1e3 * steps[name][len(step_s) // 2]:.2f}, "
              f"min {1e3 * steps[name][0]:.2f}; streams {digest}; launches {used}", flush=True)
        del eng
        torch.cuda.empty_cache()
    # a decode step at B 4 gives each expert max(int(4 * top_k * cf / E), top_k)
    # slots, so every step reads every expert's weights: the bound is the
    # weights read (all but the embedding table, of which B rows) over HBM
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params["layers"])) + sum(
        x.numel() * x.element_size() for x in (params["final_norm"], params["tok"]["lm_head"]))
    med = steps["standalone/serialized/paged=True"]
    print(f"families {MOE_ARCH} decode at B {len(prompts)}: each expert gets "
          f"{max(int(len(prompts) * m.top_k * m.capacity_factor / m.num_experts), m.top_k)} "
          f"slots, so a step reads {weight_bytes / 1e9:.2f} GB of weights; bound "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms; measured median "
          f"{1e3 * med[len(med) // 2]:.2f} ms a step (serialized paged, host clock on {card})",
          flush=True)

    # first-token logits, kernel path vs plain path, and the noise floor: the
    # plain path against itself with the prompt's rows in two query blocks
    # instead of one. Each path's routing choices are recorded, layer by layer
    plain = ExecConfig(impl="torch")
    tok = torch.from_numpy(prompts[-1]).to(cuda)[None]
    routes = {}

    def routed(tag, exec_cfg):
        moe_ffn = backbone.moe_ffn

        def recording(p, x, cfg_, ex):
            logits = (x.reshape(-1, x.shape[-1]) @ p["router"].to(x.dtype)).float()
            top = torch.topk(torch.softmax(logits, dim=-1), m.top_k, dim=-1).indices
            routes.setdefault(tag, []).append(top)
            return moe_ffn(p, x, cfg_, ex)

        with mock.patch.object(backbone, "moe_ffn", recording):
            return backbone.prefill(params, {"tokens": tok}, cfg, exec_cfg)[0]

    got = routed("kernel", ExecConfig())
    want = routed("plain", plain)
    with _plain_q_block(-(-tok.shape[1] // 2)):
        floor = routed("floor", plain)

    def differing(tag):
        """(token, k) routing choices of `tag` that the plain path did not make."""
        return sum(int((a[:, :, None] != b[:, None, :]).all(-1).sum())
                   for a, b in zip(routes[tag], routes["plain"]))

    choices = L * tok.shape[1] * m.top_k
    for what, a in (("kernel vs plain", got), ("noise floor (plain path, q_block halved) vs "
                                                "plain", floor)):
        if not torch.isfinite(a.float()).all():
            raise RuntimeError(f"{MOE_ARCH} {what}: non-finite first-token logits")
    _, rel = _rel(got, want)
    _, rel_floor = _rel(floor, want)
    print(f"first-token logits, {MOE_ARCH} prefill: kernel vs plain on the card {rel:.3e} "
          f"(row-normalised, tol {TOL_LOGITS_MOE:g}), routing choices that differ "
          f"{differing('kernel')} of {choices}; noise floor (the plain path with its "
          f"{tok.shape[1]} query rows in two blocks) {rel_floor:.3e}, routing choices that "
          f"differ {differing('floor')}; argmax {int(got.argmax())} vs {int(want.argmax())} "
          f"(floor {int(floor.argmax())})", flush=True)
    if rel > TOL_LOGITS_MOE:
        raise RuntimeError(f"{MOE_ARCH}: kernel path logits disagree ({rel:.3e})")

    # where a continuous run's time goes
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall = serve("standalone", "continuous", True)
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in on_card)
    print(f"profile {MOE_ARCH} standalone continuous paged: wall {wall:.3f} s with the "
          f"profiler on, device busy {busy_us / 1e6:.3f} s = {busy_us / 1e6 / wall:.1%} of wall",
          flush=True)
    for e in sorted(on_card, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}", flush=True)
    _print_port_kernels(on_card)
    del params


def _frontend_model(checks, card, arch):
    """qwen2-vl-72b (patch embeddings at three M-RoPE streams) or
    musicgen-medium (frame embeddings) through prefill, MAX_NEW greedy
    serve_steps (musicgen's fed seeded frames), and an extend_step of EXTEND
    tokens from the saved cache against EXTEND serve_steps."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import backbone
    from repro_torch.models.layers import ExecConfig

    cuda = torch.device("cuda")
    cfg = get_config(arch)
    cut = ""
    if arch == VL_ARCH:
        cfg = dataclasses.replace(cfg, num_layers=VL_LAYERS)
        cut = f", depth cut to {VL_LAYERS} of {get_config(arch).num_layers} layers"
    L, d = cfg.num_layers, cfg.d_model
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    t = time.perf_counter()
    params = backbone.init_params(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"init: {time.perf_counter() - t:.1f} s for {arch} ({n_params / 1e9:.2f} B params, bf16, "
        f"full width{cut})")
    b, s = REC_BATCH, max(PROMPT_LENS)
    # the stubbed frontends' embeddings, at the token embedding's scale
    embeds = (torch.randn(b, s, d, generator=gen, device=cuda) * 0.02).to(torch.bfloat16)
    frames = (torch.randn(MAX_NEW, b, d, generator=gen, device=cuda) * 0.02).to(torch.bfloat16)
    batch = {"embeds": embeds}
    if arch == VL_ARCH:
        # Qwen2-VL's layout (arXiv:2409.12191 §2.1): a text prefix with
        # t = h = w = i, then a grid of patches at t = VL_TEXT with h and w
        # its row and column
        grid = int((s - VL_TEXT) ** 0.5)
        assert VL_TEXT + grid * grid == s
        text = np.arange(VL_TEXT)
        row, col = np.divmod(np.arange(grid * grid), grid)
        streams = np.stack([np.concatenate([text, np.full(grid * grid, VL_TEXT)]),
                            np.concatenate([text, VL_TEXT + row]),
                            np.concatenate([text, VL_TEXT + col])])
        batch["positions"] = torch.from_numpy(streams).to(cuda, torch.int32)[:, None].expand(
            3, b, s)
    per_prefill, per_step = {"flash_attention": L}, {"decode_attention": L}

    def counted(what, want, fn):
        return _counted(checks, f"{arch} {what}", want, fn)

    def finite(what, logits):
        if not torch.isfinite(logits.float()).all():
            raise RuntimeError(f"{arch} {what}: non-finite logits")

    for ck in checks.values():
        ck.kernel.launches = 0
    (first, cache), prefill_s = counted(
        "prefill", per_prefill, lambda: backbone.prefill(params, batch, cfg))
    finite("prefill", first)
    cache = backbone._grow_cache(cache, cfg, s + MAX_NEW + EXTEND)
    tok, step_s = first.argmax(-1), []
    for i in range(MAX_NEW):
        kw = {"embeds": frames[i]} if arch == AUDIO_ARCH else {}
        (logits, cache), secs = counted(
            f"serve_step {i}", per_step, lambda: backbone.serve_step(params, cache, tok, cfg, **kw))
        finite(f"serve_step {i}", logits)
        step_s.append(secs)
        tok = logits.argmax(-1)
    saved = _clone(cache)
    ext_tok, step_logits = [], []
    for i in range(EXTEND):
        ext_tok.append(tok)
        (logits, cache), _ = counted(f"serve_step {MAX_NEW + i}", per_step,
                                     lambda: backbone.serve_step(params, cache, tok, cfg))
        step_logits.append(logits)
        tok = logits.argmax(-1)
    (ext_logits, _), ext_s = counted(
        "extend_step", {}, lambda: backbone.extend_step(params, _clone(saved),
                                                        torch.stack(ext_tok, 1), cfg))
    finite("extend_step", ext_logits)
    for ck in checks.values():
        ck.path_launches += ck.kernel.launches
    ext_rel = max(_rel(ext_logits[:, i], step_logits[i])[1] for i in range(EXTEND))
    print(f"families {arch}: prefill {b}x{s} {'patch' if arch == VL_ARCH else 'frame'} "
          f"embeddings {prefill_s:.3f} s wall, decode {np.mean(step_s) * 1e3:.1f} ms per step "
          f"(min {min(step_s) * 1e3:.1f}, max {max(step_s) * 1e3:.1f}) over {MAX_NEW} greedy "
          f"serve_steps, extend_step of {EXTEND} tokens {ext_s * 1e3:.1f} ms; host clock on "
          f"{card}; extend_step vs {EXTEND} serve_steps from the same cache, logits "
          f"(row-normalised) {ext_rel:.3e} (tol {TOL_EXTEND:g})", flush=True)
    if ext_rel > TOL_EXTEND:
        raise RuntimeError(f"{arch}: extend_step disagrees with serve_steps ({ext_rel:.3e})")
    want, _ = backbone.prefill(params, batch, cfg, ExecConfig(impl="torch"))
    finite("plain prefill", want)
    _, rel = _rel(first, want)
    cos = torch.nn.functional.cosine_similarity(first.float(), want.float(), dim=-1).min()
    print(f"first-token logits, {arch} prefill: kernel vs plain on the card {rel:.3e} "
          f"(row-normalised, tol {TOL_LOGITS:g}), cosine {float(cos):.6f}; argmax "
          f"{first.argmax(-1).tolist()} vs {want.argmax(-1).tolist()}", flush=True)
    if rel > TOL_LOGITS:
        raise RuntimeError(f"{arch}: kernel path logits disagree ({rel:.3e})")
    del params, cache, saved


# --------------------------------------------------------------- planning
PLANNING_EXAMPLES = ("serve_disaggregated", "carbon_planner", "fleet_allocate", "autoscale")
# the vector core's drain in scale mode (tests/test_scale_smoke.py's size)
DRAIN_REPLICAS, DRAIN_REQUESTS, DRAIN_SPAN_S = 1000, 100_000, 120.0


def phase_planning(tree: pathlib.Path) -> None:
    """The paper's planning stack on this machine's host (numpy; no JAX is
    installed here): the four planning examples of `tree` at their own
    scale, a vector-core drain of 1000 replicas, and Algorithm 1's
    contract on the scheduler's decision table."""
    import contextlib
    import io
    import runpy

    import numpy as np

    from repro_torch.core.disagg import standard_catalog
    from repro_torch.core.profiler import WorkloadPoint, profile
    from repro_torch.core.scheduler import collaborative_filtering, schedule
    from repro_torch.serving.vector_core import VectorFleetSim
    from repro_torch.serving.workload import DATASETS, sample_requests

    secs = {}
    printed = {}
    for name in PLANNING_EXAMPLES:
        t = time.perf_counter()
        main_fn = runpy.run_path(str(tree / "examples" / f"torch_{name}.py"))["main"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main_fn()
        secs[name] = time.perf_counter() - t
        printed[name] = out.getvalue()
        print(f"planning example torch_{name}.py ({secs[name]:.2f} s):\n"
              + printed[name].rstrip(), flush=True)

    # Algorithm 1 at serve_disaggregated's scale: 9 configs x 12 workloads,
    # 60 s windows, 70% of the cells profiled, the rest completed by ALS
    t = time.perf_counter()
    catalog = standard_catalog()
    workloads = [WorkloadPoint(ds, "p50", q) for ds in ("sharegpt", "humaneval", "longbench")
                 for q in (0.5, 1.0, 2.0, 4.0)]
    db = profile(catalog, workloads, duration_s=60.0, coverage=0.7, seed=1)
    slo_target = 0.9
    decisions = schedule(db, slo_target=slo_target, priority="slo")
    c, s = collaborative_filtering(db)
    if sorted(decisions) != sorted(db.workloads):
        raise RuntimeError(f"schedule decided {sorted(decisions)}, not every workload")
    for j, w in enumerate(db.workloads):
        d = decisions[w]
        i = db.configs.index(d.config)
        feasible = np.flatnonzero(s[:, j] >= slo_target)
        if (d.expected_carbon_g_per_token, d.expected_slo_attainment) != (c[i, j], s[i, j]):
            raise RuntimeError(f"{w}: the decision's expectations are not the matrices'")
        if d.feasible != bool(feasible.size):
            raise RuntimeError(f"{w}: feasible={d.feasible}, but {feasible.size} configs meet "
                               f"the SLO target")
        if d.feasible and not (s[i, j] >= slo_target and c[i, j] == c[feasible, j].min()):
            raise RuntimeError(f"{w}: {d.config} is not the least-carbon feasible config")
        if not d.feasible and s[i, j] != s[:, j].max():
            raise RuntimeError(f"{w}: {d.config} is not the best-SLO fallback")
        row = (f"{w:24s} {d.config:20s} {d.expected_carbon_g_per_token*1e3:8.4f} "
               f"{d.expected_slo_attainment:6.2f} {str(d.feasible):>4s}")
        if row not in printed["serve_disaggregated"].splitlines():
            raise RuntimeError(f"the example's decision table lacks {row!r}")
    secs["algorithm1"] = time.perf_counter() - t
    print(f"planning algorithm 1: {len(db.entries)}/{len(catalog) * len(workloads)} cells "
          f"profiled; every workload decided; {sum(d.feasible for d in decisions.values())} "
          f"feasible decisions are the least-carbon feasible configs, the rest the best-SLO "
          f"fallback; the example printed this table ({secs['algorithm1']:.2f} s)", flush=True)

    # the vector core in scale mode: every request finishes with its tokens
    t = time.perf_counter()
    ds = DATASETS["sharegpt"]
    cfg = next(c for c in catalog if c.name == "standalone")
    reqs = sample_requests(ds, qps=DRAIN_REQUESTS / DRAIN_SPAN_S, duration_s=DRAIN_SPAN_S,
                           seed=0, fixed_size=ds.size_at("p50"))
    if len(reqs) < DRAIN_REQUESTS:
        raise RuntimeError(f"drew {len(reqs)} requests, fewer than {DRAIN_REQUESTS}")
    parts = [reqs[i::DRAIN_REPLICAS] for i in range(DRAIN_REPLICAS)]
    stats = VectorFleetSim(cfg.mode, cfg.target, parts, seeds=list(range(DRAIN_REPLICAS)),
                           rng_mode="batched", record_segments=False).drain().stats()
    secs["drain"] = time.perf_counter() - t
    if (stats["n_replicas"], stats["n_requests"], stats["finished"]) != \
            (DRAIN_REPLICAS, len(reqs), len(reqs)):
        raise RuntimeError(f"drain lost requests: {stats}")
    if stats["total_tokens"] != stats["expected_tokens"]:
        raise RuntimeError(f"drain emitted {stats['total_tokens']} tokens, expected "
                           f"{stats['expected_tokens']}")
    for chip, busy in stats["busy_s"].items():
        energy = stats["energy_j"][chip]
        if not (np.isfinite(busy) and busy >= 0.0 and np.isfinite(energy) and energy >= 0.0):
            raise RuntimeError(f"drain: {chip} busy {busy} s, energy {energy} J")
    if not np.isfinite(stats["max_finish_s"]):
        raise RuntimeError(f"drain: max finish {stats['max_finish_s']}")
    print(f"planning drain: {DRAIN_REPLICAS} replicas x {len(reqs)} requests, every request "
          f"finished with its {stats['expected_tokens']} tokens in all; modelled max finish "
          f"{stats['max_finish_s']:.1f} s ({secs['drain']:.2f} s)", flush=True)
    print("planning host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"; total {sum(secs.values()):.2f}", flush=True)


# --------------------------------------------------------------- training
# llama-7b at full width (d_model 4096, 32 heads of 128, d_ff 11008, vocab
# 32000, untied head) with its depth cut to TRAIN_LAYERS of 32 so that the
# AdamW state (16 B a param: bf16 weights and gradients, fp32 master, m, v)
# fits one card with room for activations (PERF.md, PR 18: 2.69 B params,
# 43.1 GB); TRAIN_BATCH x TRAIN_SEQ tokens a step; TRAIN_STEPS steps on one
# batch at TRAIN_LR
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "llama-7b", 12, 4, 1024
TRAIN_STEPS, TRAIN_LR = 6, 1e-4
# the other families, one step each at 2 x 1024 tokens: (arch, layers; None
# for full depth). qwen2-vl-72b is left to the CPU tests: its embedding and
# head alone are 2.49 B params, ~40 GB of training state
TRAIN_FAMILIES = (("qwen2-moe-a2.7b", 2), ("rwkv6-7b", 2), ("zamba2-2.7b", 6),
                  ("musicgen-medium", None))
# the sharded step with the sequence-parallel carry and the expert-parallel
# dispatch, on one rank: qwen2-moe cut as TRAIN_FAMILIES cuts it, 2 x 1024
# tokens in groups of 64 (32 groups, so the groups stay on the data axis, as
# on every production cell, and go through the all-to-all)
SP_ARCH, SP_LAYERS, SP_GROUP = "qwen2-moe-a2.7b", 2, 64
# the restart check: the launcher's defaults (8 x 64 tokens, lr 1e-3)
TRAIN_CKPT_ARCH, TRAIN_CKPT_STEPS, TRAIN_CKPT_EVERY = "llama-300m", 12, 6
#   the restarted run's losses against the launcher's printed ones (4
#   decimals), relative, where they are not identical to the printed
#   digits: the first probe, whose embedding gradient still summed with
#   atomics, read 5.7e-5 by step 12 (PERF.md, PR 18)
TOL_RESTART = 2e-4
# activations and the update's temporaries beside the 16 B a param: the
# remat's layer inputs, one layer recomputed (fp32 scores of a query block
# and their softmax), the fp32 logits and their gradient (PERF.md, PR 18)
TRAIN_ACT_ALLOWANCE = 12 * 2**30
#   bf16 training against the same model upcast to fp32 at step 1 (relative
#   loss and gradient-norm difference): largest readings 9.8e-5 (loss,
#   qwen2-moe) and 7.4e-4 (gradient norm, musicgen-medium) over the five
#   models (PERF.md, PR 18); limits ~3x. The phase also reads a noise floor,
#   bf16 against itself with its query rows in blocks of half the sequence:
#   0 for the loss (each query row's scores are the same products either
#   way) and 0 to 8.6e-5 for the gradient norm (the backward products'
#   sums in another order)
TOL_TRAIN = {"loss": 3e-4, "grad_norm": 2.5e-3}
#   microbatches=2 against 1, both bf16: readings 8.8e-8 (loss) and 1.9e-6
#   (gradient norm: bf16 gradients summed in fp32 against one pass)
TOL_MICRO = {"loss": 5e-7, "grad_norm": 1e-5}
#   the sharded step on a (1, 1) mesh against train_step: the same math but
#   the vocab-parallel loss's own fp32 formula; loss relative, params in
#   units of lr after one step (bf16 gradients can round the other way)
#   no element off by more than 3 lr (a near-zero gradient that rounds to the
#   other sign turns Adam's first step), at most 1% off by more than 0.1 lr
#   (reading 3.1e-3 with 2.2 lr at most; PERF.md, PR 18)
TOL_SHARDED = {"loss": 1e-4, "params_lr": 3.0, "off_share": 1e-2}


def phase_training(checks, card):
    """Training on the card: llama-7b's AdamW steps at full width, one step
    of each other family, the sharded and compressed steps through a
    one-rank nccl group, and a checkpoint restart through the launcher. No
    kernel may launch: the reference trains with use_kernels=False."""
    import torch

    from repro_torch.kernels import ops as kops

    t0 = time.perf_counter()
    before = {n: ck.kernel.launches for n, ck in checks.items()}
    # the kernels have no backward: the front door refuses a grad input
    q = torch.randn(1, 16, 4, 128, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    try:
        kops.flash_attention(q, q, q)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"training: a CUDA input that requires a gradient is refused: {e}", flush=True)
    else:
        raise RuntimeError("flash_attention took an input that requires a gradient")
    dense = _train_dense(card)
    torch.cuda.empty_cache()
    for arch, layers in TRAIN_FAMILIES:
        _train_family(arch, layers)
        torch.cuda.empty_cache()
    _train_distributed(card)
    torch.cuda.empty_cache()
    used = {n: ck.kernel.launches - before[n] for n, ck in checks.items()}
    if any(used.values()):
        raise RuntimeError(f"training launched kernels: {used}")
    print(f"training: kernel launches over the phase {used}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dense


def _batch(cfg, b, s, step=0):
    from repro_torch.training.data import synthetic_batch, to_device

    return to_device(synthetic_batch(cfg, b, s, 0, step), "cuda")


def _bf16_vs_fp32(params, batch, cfg, what):
    """Loss and gradient norm of bf16 params against the same model upcast
    to fp32, beside the bf16 noise floor (query rows in blocks of half the
    sequence); before any optimizer state exists. Returns the bf16 pair."""
    import dataclasses

    import torch

    from repro_torch.models.layers import TRAIN_EXEC
    from repro_torch.training.optimizer import global_norm, tree_map
    from repro_torch.training.train_step import loss_and_grads

    def run(p, c, ex, b=batch):
        loss, g = loss_and_grads(p, b, c, ex)
        out = (float(loss), float(global_norm(g)))
        del g
        return out

    s = next(iter(batch.values())).shape[-1]
    l16, n16 = run(params, cfg, TRAIN_EXEC)
    lf, nf = run(params, cfg, dataclasses.replace(TRAIN_EXEC, q_block=max(s // 2, 1)))
    p32 = tree_map(lambda t: t.float(), params)
    b32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    l32, n32 = run(p32, dataclasses.replace(cfg, dtype="float32"), TRAIN_EXEC, b32)
    del p32, b32
    torch.cuda.empty_cache()
    err = {"loss": abs(l16 - l32) / abs(l32), "grad_norm": abs(n16 - n32) / n32}
    floor = {"loss": abs(lf - l16) / abs(l16), "grad_norm": abs(nf - n16) / n16}
    print(f"{what}: bf16 loss {l16:.6f} gnorm {n16:.6f}, fp32 loss {l32:.6f} gnorm "
          f"{n32:.6f}: rel {err['loss']:.3e} / {err['grad_norm']:.3e} (tol {TOL_TRAIN['loss']:g}"
          f" / {TOL_TRAIN['grad_norm']:g}); noise floor (bf16, query blocks of {s // 2}) "
          f"{floor['loss']:.3e} / {floor['grad_norm']:.3e}", flush=True)
    if not all(x == x and abs(x) != float("inf") for x in (l16, n16)):
        raise RuntimeError(f"{what}: non-finite loss or gradient norm")
    if any(err[k] > TOL_TRAIN[k] for k in err):
        raise RuntimeError(f"{what}: bf16 training disagrees with fp32: {err}")
    return l16, n16


def _train_dense(card):
    import dataclasses
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import backbone
    from repro_torch.models.layers import TRAIN_EXEC
    from repro_torch.training.optimizer import AdamWConfig, global_norm, init_opt_state
    from repro_torch.training.train_step import loss_and_grads, train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    n = cfg.param_count()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    state_bytes = 16 * n
    print(f"training {TRAIN_ARCH} at full width, {TRAIN_LAYERS} of 32 layers: {n / 1e9:.3f} B "
          f"params; reckoning 16 B a param = {state_bytes / 2**30:.2f} GiB of state + "
          f"{TRAIN_ACT_ALLOWANCE / 2**30:.0f} GiB for activations and the update = "
          f"{(state_bytes + TRAIN_ACT_ALLOWANCE) / 2**30:.2f} GiB; {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens a step; card {card}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = backbone.init_params(gen, cfg)
    batch = _batch(cfg, TRAIN_BATCH, TRAIN_SEQ)
    # (a) bf16 against fp32 at step 1, before any optimizer state
    l1, n1 = _bf16_vs_fp32(params, batch, cfg, f"{TRAIN_ARCH} step 1")
    peak_a = torch.cuda.max_memory_allocated()
    # (b) two microbatches against one
    lm, g = loss_and_grads(params, batch, cfg, TRAIN_EXEC, microbatches=2)
    lm, nm = float(lm), float(global_norm(g))
    del g
    err = {"loss": abs(lm - l1) / abs(l1), "grad_norm": abs(nm - n1) / n1}
    print(f"{TRAIN_ARCH} microbatches=2 against 1: loss {lm:.6f} vs {l1:.6f}, gnorm {nm:.6f} "
          f"vs {n1:.6f}: rel {err['loss']:.3e} / {err['grad_norm']:.3e} (tol "
          f"{TOL_MICRO['loss']:g} / {TOL_MICRO['grad_norm']:g})", flush=True)
    if any(err[k] > TOL_MICRO[k] for k in err):
        raise RuntimeError(f"microbatches=2 disagree with 1: {err}")
    torch.cuda.empty_cache()
    # (c) TRAIN_STEPS AdamW steps on the one batch
    torch.cuda.reset_peak_memory_stats()
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    opt = init_opt_state(params)
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = train_step(params, opt, batch, cfg, opt_cfg, TRAIN_EXEC)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
    print(f"{TRAIN_ARCH} {TRAIN_STEPS} AdamW steps (lr {TRAIN_LR:g}) on one batch: losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; step s {', '.join(f'{x:.4f}' for x in secs)}",
          flush=True)
    if not losses[-1] < losses[0] or not all(map(lambda x: x == x, losses)):
        raise RuntimeError(f"the loss did not fall: {losses}")
    # (d) peak memory within the reckoning
    peak = torch.cuda.max_memory_allocated()
    bound = state_bytes + TRAIN_ACT_ALLOWANCE
    print(f"{TRAIN_ARCH} peak device memory {peak / 2**30:.2f} GiB over the steps "
          f"(the bf16-vs-fp32 check {peak_a / 2**30:.2f} GiB) against the reckoning "
          f"{bound / 2**30:.2f} GiB", flush=True)
    if peak > bound:
        raise RuntimeError(f"peak {peak / 2**30:.2f} GiB beyond the reckoning")
    # (e) step time, tokens/s, model-FLOPs share, device-busy share
    step_s = statistics.median(secs[1:])
    n_matmul = n - cfg.vocab_size * cfg.d_model        # all but the embedding table
    model_flops = 6 * n_matmul * tokens + 12 * cfg.num_layers * TRAIN_SEQ * cfg.d_model * tokens
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = train_step(params, opt, batch, cfg, opt_cfg, TRAIN_EXEC)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in on_card)
    # the step's two parts: loss and gradients, then the bf16 cast and AdamW
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, g = loss_and_grads(params, batch, cfg, TRAIN_EXEC)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t
    del g
    print(f"{TRAIN_ARCH} train step parts: loss and gradients {grad_s * 1e3:.1f} ms, the "
          f"update (bf16 cast, AdamW, params copied back) ~{(step_s - grad_s) * 1e3:.1f} ms",
          flush=True)
    print(f"{TRAIN_ARCH} train step: {step_s * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}, "
          f"host clock around synchronised steps), {tokens / step_s:.0f} tokens/s, model "
          f"FLOPs {model_flops:.3e} a step = {model_flops / step_s / BF16_FLOPS:.1%} of "
          f"989e12; profiled step: wall {wall:.3f} s, device busy {busy_us / 1e6:.3f} s = "
          f"{busy_us / 1e6 / wall:.1%}; card {card}", flush=True)
    for e in sorted(on_card, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}", flush=True)
    del params, opt, batch, m
    return {"peak_bytes": peak, "model_flops": model_flops}


def _train_family(arch, layers):
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import backbone
    from repro_torch.models.layers import TRAIN_EXEC
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import train_step

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = backbone.init_params(gen, cfg)
    batch = _batch(cfg, 2, 1024)
    what = f"{arch} ({cfg.family}, {cfg.num_layers} layers, {cfg.param_count() / 1e9:.2f} B)"
    l1, _ = _bf16_vs_fp32(params, batch, cfg, what)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, opt, m = train_step(params, opt, batch, cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=1),
                                TRAIN_EXEC)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    if float(m["loss"]) != float(m["loss"]) or abs(float(m["loss"]) - l1) > 1e-3 * abs(l1):
        raise RuntimeError(f"{what}: train_step loss {float(m['loss'])} vs {l1}")
    print(f"{what}: one train_step of 2 x 1024 tokens in {secs:.3f} s, gnorm "
          f"{float(m['grad_norm']):.4f}", flush=True)
    del params, opt, batch, m


def _train_distributed(card):
    """The sharded and compressed steps through a one-rank nccl group, and
    the launcher's checkpoints restored by a second trainer."""
    import copy
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import backbone
    from repro_torch.models.layers import TRAIN_EXEC
    from repro_torch.training import train_step as ts
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        cfg = get_config(TRAIN_CKPT_ARCH)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = backbone.init_params(gen, cfg)
        batch = _batch(cfg, 8, 256)
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
        mesh = make_host_mesh(1, 1, device_type="cuda")
        _sharded_vs_plain(f"{TRAIN_CKPT_ARCH}, 8 x 256", copy.deepcopy(params), batch, cfg,
                          opt_cfg, TRAIN_EXEC, mesh)
        step = ts.make_compressed_train_step(cfg, opt_cfg, TRAIN_EXEC)
        pc = copy.deepcopy(params)
        pc, _, _, mc = step(pc, init_opt_state(pc), ts.init_residual(pc), batch)
        if float(mc["loss"]) != float(mc["loss"]):
            raise RuntimeError("the compressed step gave a NaN loss")
        print(f"compressed step on one nccl rank: loss {float(mc['loss']):.6f} gnorm "
              f"{float(mc['grad_norm']):.4f}", flush=True)
        del params, pc, batch
        torch.cuda.empty_cache()
        # the sequence-parallel carry and the expert-parallel dispatch: on one
        # rank the all-to-all is an identity, but every collective and
        # autograd function of the region runs on CUDA tensors over nccl
        if _has_carry():
            moe = dataclasses.replace(get_config(SP_ARCH), num_layers=SP_LAYERS)
            gen.manual_seed(0)
            ex = dataclasses.replace(TRAIN_EXEC, carry_spec=(("data",), "model", None),
                                     ep_axes=("data",), moe_group_size=SP_GROUP)
            _sharded_vs_plain(f"{SP_ARCH}, {SP_LAYERS} layers, 2 x 1024 in groups of "
                              f"{SP_GROUP}, carry_spec {ex.carry_spec}, ep_axes {ex.ep_axes}",
                              backbone.init_params(gen, moe), _batch(moe, 2, 1024), moe,
                              AdamWConfig(lr=1e-3, warmup_steps=1), ex, mesh)
            torch.cuda.empty_cache()
        else:
            print("sequence-parallel carry: not in this tree", flush=True)
        _train_restart(cfg)
    finally:
        dist.destroy_process_group()


def _has_carry() -> bool:
    """Whether the imported port has the sequence-parallel carry (a tree
    given by --tree may predate it)."""
    from repro_torch.models.layers import ExecConfig

    return "carry_spec" in {f.name for f in dataclasses.fields(ExecConfig)}


def _sharded_vs_plain(what, params, batch, cfg, opt_cfg, ex, mesh):
    """One make_sharded_train_step on `mesh` against one train_step from the
    same params and batch, held within TOL_SHARDED. The plain step runs
    first and its params wait on the host, so one training state at a time
    is on the card."""
    import copy

    import torch

    from repro_torch.training import train_step as ts
    from repro_torch.training.optimizer import init_opt_state, tree_leaves, tree_map

    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        return out

    p1 = copy.deepcopy(params)
    p1, _, m1 = timed("plain", lambda: ts.train_step(p1, init_opt_state(p1), batch, cfg,
                                                     opt_cfg, ex))
    p1 = tree_map(lambda t: t.cpu(), p1)
    torch.cuda.empty_cache()
    sp = ts.shard_params(params, mesh)
    so = ts.shard_opt_state(init_opt_state(params), params, mesh)
    step = ts.make_sharded_train_step(mesh, cfg, opt_cfg, ex)
    p2, _, m2 = timed("sharded", lambda: step(sp, so, ts.shard_batch(batch, mesh)))
    rel = abs(float(m2["loss"]) - float(m1["loss"])) / float(m1["loss"])
    d = [(a.float() - b.full_tensor().float().cpu()).abs() / opt_cfg.lr
         for a, b in zip(tree_leaves(p1), tree_leaves(p2))]
    diff = max(float(x.max()) for x in d)
    off = sum(int((x > 0.1).sum()) for x in d) / sum(x.numel() for x in d)
    print(f"sharded step on a (1, 1) nccl mesh against train_step ({what}): loss rel "
          f"{rel:.3e} (tol {TOL_SHARDED['loss']:g}), params max diff {diff:.3f} lr (tol "
          f"{TOL_SHARDED['params_lr']:g}), {off:.2e} of them off by more than 0.1 lr (tol "
          f"{TOL_SHARDED['off_share']:g}); wall {walls['plain']:.3f} s and "
          f"{walls['sharded']:.3f} s (first calls)", flush=True)
    if rel > TOL_SHARDED["loss"] or diff > TOL_SHARDED["params_lr"] or \
            off > TOL_SHARDED["off_share"]:
        raise RuntimeError(f"the sharded step disagrees with train_step ({what})")


def _train_restart(cfg):
    """launch.train runs TRAIN_CKPT_STEPS steps with a checkpoint every
    TRAIN_CKPT_EVERY; a second trainer restores the middle one and must
    reproduce the rest: the printed losses and the final state."""
    import os
    import shutil

    import torch

    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.elastic import ElasticTrainer
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves

    src = pathlib.Path(sys.modules["repro_torch"].__file__).resolve().parents[1]
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    run_dir, last_dir = root / "run", root / "last"
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_CKPT_ARCH, "--full",
         "--steps", str(TRAIN_CKPT_STEPS), "--ckpt-every", str(TRAIN_CKPT_EVERY),
         "--ckpt-dir", str(run_dir)],
        env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    if out.returncode != 0:
        raise RuntimeError(f"launch.train failed:\n{out.stdout}\n{out.stderr[-3000:]}")
    lines = out.stdout.splitlines()
    print("\n".join(f"  | {l}" for l in lines), flush=True)
    printed = [l.split()[3] for l in lines if l.startswith("  step")]
    size = sum(f.stat().st_size for f in (run_dir / f"step_{TRAIN_CKPT_EVERY:08d}").iterdir())
    print(f"launch.train {TRAIN_CKPT_ARCH} --full: {TRAIN_CKPT_STEPS} steps and two "
          f"checkpoints of {size / 1e9:.2f} GB in {wall:.1f} s", flush=True)
    last = f"step_{TRAIN_CKPT_STEPS:08d}"
    last_dir.mkdir(parents=True)
    shutil.move(str(run_dir / last), str(last_dir / last))
    t = time.perf_counter()
    tr = ElasticTrainer(cfg, batch=8, seq=64, ckpt_dir=str(run_dir), model_axis=2,
                        opt_cfg=AdamWConfig(lr=1e-3), ckpt_every=TRAIN_CKPT_EVERY, seed=0)
    restored = tr.step
    losses = tr.run(TRAIN_CKPT_STEPS - restored)
    wall = time.perf_counter() - t
    again = [f"{x:.4f}" for x in losses]
    _, want = ckpt.restore_latest(str(last_dir), {"params": tr.params, "opt": tr.opt})
    diff = max(float((a.full_tensor().float() - b.full_tensor().float()).abs().max())
               for a, b in zip(tree_leaves(tr.params), tree_leaves(want["params"])))
    same = all(torch.equal(a.full_tensor(), b.full_tensor())
               for a, b in zip(tree_leaves([tr.params, tr.opt["m"], tr.opt["v"], tr.opt["master"]]),
                               tree_leaves([want["params"], want["opt"]["m"], want["opt"]["v"],
                                            want["opt"]["master"]])))
    print(f"restart: a second trainer restored step {restored} and ran steps "
          f"{restored + 1}-{tr.step} in {wall:.1f} s: losses {', '.join(again)} against the "
          f"launcher's {', '.join(printed[restored:])}; final params and state "
          f"{'bit-identical' if same else f'differ, params by {diff:.3e} at most'}", flush=True)
    worst = max(abs(x - float(w)) / float(w) for x, w in zip(losses, printed[restored:]))
    print(f"restart: losses {'identical to the printed digits' if again == printed[restored:] else 'differ'}"
          f", largest relative difference {worst:.3e} (tol {TOL_RESTART:g}, beside the "
          f"printed digits' 5e-5)", flush=True)
    if restored != TRAIN_CKPT_EVERY or len(again) != len(printed) - restored or \
            worst > TOL_RESTART:
        raise RuntimeError(f"the restart did not reproduce steps {restored + 1}-"
                           f"{TRAIN_CKPT_STEPS}: {again} vs {printed[restored:]}")
    shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ dryrun
# full-depth proof cells of the dry-run on the host: (arch, shape, mesh)
DRYRUN_CELLS = (("llama-7b", "train_4k", "single_pod"),
                ("qwen2-moe-a2.7b", "train_4k", "single_pod"),
                ("llama4-scout-17b-a16e", "train_4k", "single_pod"),
                ("zamba2-2.7b", "long_500k", "multi_pod"),
                ("musicgen-medium", "decode_32k", "single_pod"))
#   the dry-run's peak for the training phase's cell over the card's
#   max_memory_allocated across that phase's AdamW steps. Under 0.9: the
#   dry-run missed tensors the card held (it tracks every storage from its
#   creation to its death; the allocator only rounds blocks up to 512 B).
#   Over 1.3: it predicts the sharded step on a (1, 1) mesh (the
#   vocab-parallel loss and DTensor's redistributes) where the phase ran
#   train_step, and holds a storage until its Python object dies where the
#   card's allocator may reuse the block sooner; beyond that the prediction
#   is no guide to what a cell needs. Readings: 43.03 GiB predicted on a
#   CPU against the 43.09 GiB the training phase measured on an H100
#   (PERF.md §6)
DRYRUN_PEAK = (0.9, 1.3)
# the cell the expert-parallel dispatch and the sequence-parallel carry
# bring into the card's memory: 143.0 GB a device with the MoE run whole on
# every rank and the residual replicated over "model" (PERF.md §6)
DRYRUN_MUST_FIT = ("qwen2-moe-a2.7b", "train_4k", "single_pod")


def phase_dryrun(card, dense):
    """The dry-run (repro_torch.launch.dryrun) on the host, over fake
    process groups of 256 and 512 ranks: (a) full-depth proof cells, each
    record printed; (b) its prediction for the training phase's own cell
    against what the card measured in that phase (peak bytes, bounded by
    DRYRUN_PEAK; FLOPs beside the phase's model-FLOPs formula); (c)
    kernels/smem.py held == to each library's own launch configuration."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import build, smem
    from repro_torch.launch import dryrun as dr

    t0 = time.perf_counter()
    for arch, shape, mesh_name in DRYRUN_CELLS:
        t = time.perf_counter()
        with dr.production_mesh(mesh_name) as mesh:
            rec = dr.run_cell(arch, shape, mesh, "proof")
        secs = time.perf_counter() - t
        if rec["status"] != "ok":
            raise RuntimeError(f"dryrun {arch}/{shape}/{mesh_name}: {rec}")
        print(f"dryrun {arch}/{shape}/{mesh_name}/proof: host {secs:.1f} s; seq_parallel "
              f"{rec['seq_parallel']}, expert_parallel_dispatch "
              f"{rec['expert_parallel_dispatch']}, peak {rec['peak_bytes'] / 1e9:.2f} GB of "
              f"{rec['hbm_bytes'] / 1e9:.2f} ({'fits' if rec['fits_hbm'] else 'does not fit'}); "
              f"{json.dumps(rec)}", flush=True)
        if (arch, shape, mesh_name) == DRYRUN_MUST_FIT and _has_carry() and \
                not rec["fits_hbm"]:
            raise RuntimeError(f"dryrun {arch}/{shape}/{mesh_name} does not fit the card: "
                               f"{rec['peak_bytes']} of {rec['hbm_bytes']} bytes")
    # (b) the training phase's cell: one AdamW step of the sharded step on a
    # (1, 1) mesh, remat, microbatches 1
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    t = time.perf_counter()
    with dr.fake_mesh((1, 1), ("data", "model")) as mesh:
        rec, arg, out, _ = dr.lower_cell(
            cfg, ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH), mesh)
    pred = dr.analyze(rec, arg, out)
    secs = time.perf_counter() - t
    peak = pred["peak_bytes"] / dense["peak_bytes"]
    flops = pred["flops_per_device"] / dense["model_flops"]
    print(f"dryrun against the card ({TRAIN_ARCH}, {TRAIN_LAYERS} layers, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, AdamW, remat, (1, 1) mesh): peak {pred['peak_bytes'] / 2**30:.3f}"
          f" GiB predicted (arguments {arg / 2**30:.3f} + temp "
          f"{pred['temp_bytes'] / 2**30:.3f}) vs {dense['peak_bytes'] / 2**30:.3f} GiB "
          f"max_memory_allocated over the training phase's steps: {peak:.4f} (limits "
          f"{DRYRUN_PEAK[0]}-{DRYRUN_PEAK[1]}); FLOPs {pred['flops_per_device']:.4e} counted "
          f"(remat recompute included) vs {dense['model_flops']:.4e} model FLOPs a step: "
          f"{flops:.4f}; host {secs:.1f} s; card {card}", flush=True)
    if not DRYRUN_PEAK[0] <= peak <= DRYRUN_PEAK[1]:
        raise RuntimeError(f"the dry-run's peak is {peak:.4f}x the card's")
    # (c) smem.py against the libraries (built by the build phase; cached)
    build.build_all()
    path = ("flash D128 b2", "flash D80 b2", "decode D128 G1 b2", "paged_decode D128 G1 b2 bs16 "
            "chunk1024", "paged_prefill D128 b2 pages1", "wkv N64 b2", "ssd N64 P64 b2")
    n = 0
    for label, source, symbol, args, est in smem.cases():
        dyn, static, regs, threads = build.query(source, symbol, *args)
        if (dyn, static, threads) != (est.dynamic_bytes, est.static_bytes, est.threads) or \
                not smem.regs_fit(regs, threads):
            raise RuntimeError(f"smem.py {label}: {est} vs {symbol}{args} = dynamic {dyn}, "
                               f"static {static}, {regs} registers, {threads} threads")
        if label in path:
            print(f"  smem {label}: {dyn} + {static} bytes of {smem.SMEM_BYTES}, {regs} "
                  f"registers x {threads} threads", flush=True)
        n += 1
    print(f"dryrun: smem.py == each library's own launch configuration at {n} instantiations; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)


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


def _plain_q_block(q_block: int):
    """A context in which the plain flash version runs its query rows in
    blocks of `q_block`: the same function in another summation order."""
    from unittest import mock

    from repro_torch.kernels import flash_attention as fla

    plain = fla.flash_attention_plain

    def blocked(q, k, v, causal=True, _=None):
        return plain(q, k, v, causal, q_block)

    return mock.patch.object(fla, "flash_attention_plain", blocked)


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
    torch.cuda.empty_cache()
    if other is not None and not hasattr(importlib.import_module("repro_torch.models.layers"),
                                         "moe_ffn"):
        print("families: not in this tree", flush=True)
    else:
        phase_families(checks, card)
    if other is not None and importlib.util.find_spec("repro_torch.core.disagg") is None:
        print("planning: not in this tree", flush=True)
    else:
        phase_planning(other or ROOT)
    torch.cuda.empty_cache()
    if other is not None and importlib.util.find_spec("repro_torch.training") is None:
        print("training: not in this tree", flush=True)
    else:
        dense = phase_training(checks, card)
        if other is not None and importlib.util.find_spec("repro_torch.launch.dryrun") is None:
            print("dryrun: not in this tree", flush=True)
        else:
            phase_dryrun(card, dense)
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
