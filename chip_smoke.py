#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA H100 and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases; any failure raises, and the script then exits non-zero and prints
no result:

  device   CUDA present with capability 9.0; the card's name and power limit
           from nvidia-smi.
  build    nvcc builds every kernel from src/repro_torch/csrc (one process
           per source, all at once).
  kernels  each hand-written kernel against its plain PyTorch version
           (impl="torch") on the card, and against the fp32 oracle of
           kernels/ref.py, at the target's and the draft's engine shapes and
           at small ones: grouped heads G in {1, 4, 8}, ragged lengths,
           odd S, a ctx == 0 chunk, pages shared with refcount > 1, a pool
           poisoned with finite +-1e4, bf16 and fp32. Then kernel, plain
           version and one PyTorch library call (the yardstick; the port
           never calls it) are timed at the shapes the engine runs.
  engine   ServingEngine at the full width of the paper's llama-7b target
           (bf16, random weights from the port's seeded init), with a
           llama-1b draft for spec/dsd: 4 requests, ragged prompts of a few
           hundred tokens, 16 new tokens each, greedy. standalone
           (serialized paged and dense, continuous paged), dpd, spec, dsd.
           The kernels' launch counts are zeroed before and read after;
           every kernel must have launched. Then first-token logits of the
           kernel path (target and draft) are held against the plain path
           on the card, and torch.profiler records one more run (device
           busy share, top kernels by device time).

The engine's modelled clock, energy and carbon are the cost model's figures
for the chips it names (a100 new, t4 old), not measurements of this card.
The last lines of standard output are: the nvidia-smi line, one JSON object
{"kernels": [...]}, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
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
#   bf16: the plain version rounds its scores and probabilities to bf16
#         before the value product; the kernel keeps them in fp32 (largest
#         readings: flash and paged prefill 6.3e-2, the decodes 2.7e-2)
TOL_PLAIN = {"float32": 2e-5,
             "bfloat16": {"flash_attention": 2e-1, "decode_attention": 8e-2,
                          "paged_decode_attention": 8e-2,
                          "paged_prefill_attention": 2e-1}}
#   against the fp32 oracle a bf16 kernel differs by its output rounding only
#   (largest readings: flash 1.3e-2, paged prefill 2.2e-2, the decodes
#   1.3e-3; half an ulp of an element ~3x its row's RMS is 5.9e-3)
TOL_ORACLE_BF16 = {"flash_attention": 4e-2, "decode_attention": 1e-2,
                   "paged_decode_attention": 1e-2, "paged_prefill_attention": 6e-2}
#   first-token logits, kernel path vs plain path, both bf16: every layer
#   adds one attention output's bf16 difference (largest reading 9.4e-2)
TOL_LOGITS = 2.5e-1

PROMPT_LENS = (287, 333, 402, 451)
MAX_NEW = 16
BLOCK = 16


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
    from repro_torch.kernels import build

    t = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t
    for src, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                log(f"[ptxas {src}] {line.strip()}")
    print(f"build: {secs:.1f} s for {len(logs)} sources "
          f"({', '.join(build.SOURCES)})", flush=True)
    return secs


# ---------------------------------------------------------------- helpers
def _rel(a, b) -> tuple[float, float]:
    """(max abs error, largest row-normalised error): rows are the last
    axis, each row's max|a - b| over the RMS of b's row."""
    d = (a.float() - b.float()).abs().reshape(-1, b.shape[-1])
    rms = b.float().reshape(-1, b.shape[-1]).pow(2).mean(-1).sqrt()
    return d.max().item(), (d.amax(-1) / rms.clamp_min(1e-6)).max().item()


def _time_ms(fn, iters: int = 20) -> float:
    """Mean device ms per call, each call after an L2 flush (the 50 MB L2
    would otherwise hold a decode's whole K/V between calls)."""
    import torch

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
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
        self.engine_launches = 0

    def hold(self, got, plain, oracle, dtype, what: str) -> None:
        import torch

        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{self.name} {what}: non-finite output")
        key = str(dtype).split(".")[-1]
        tol = TOL_PLAIN[key]
        tol = tol[self.name] if isinstance(tol, dict) else tol
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
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": self.engine_launches,
                "max_abs_err": self.max_abs_err, "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


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
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pag
    from repro_torch.models.config import AttentionConfig
    from repro_torch.serving.kv_cache import PagedKVPool

    f32, bf16 = torch.float32, torch.bfloat16
    cuda = torch.device("cuda")

    def rand(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

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
    }
    es = 2  # bytes per bf16 element at the timed (main-path) shapes

    # ---- flash: (B, S, H, KV, D, dtype); odd S, G in {1, 4, 8}
    c = checks["flash_attention"]
    for b, s, h, kv, d, dt in [(1, max(PROMPT_LENS), kvh7 * g7, kvh7, d7, bf16),
                               (1, max(PROMPT_LENS), kvh1 * g1, kvh1, d1, bf16),
                               (2, 77, 8, 8, 128, f32), (2, 129, 16, 4, 64, bf16),
                               (1, 200, 32, 4, 128, f32), (3, 33, 8, 1, 32, f32)]:
        q, k, v = rand(b, s, h, d, dtype=dt), rand(b, s, kv, d, dtype=dt), rand(b, s, kv, d, dtype=dt)
        got = ops.flash_attention(q, k, v)
        plain = ops.flash_attention(q, k, v, impl="torch")
        oracle = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2)).transpose(1, 2)
        c.hold(got, plain, oracle, dt, f"B={b} S={s} H={h} KV={kv} D={d} {dt}")
    b, s, h, kv, d = 1, max(PROMPT_LENS), tgt.attn.num_heads, kvh7, d7
    q, k, v = rand(b, s, h, d, dtype=bf16), rand(b, s, kv, d, dtype=bf16), rand(b, s, kv, d, dtype=bf16)
    qh, kh, vh = q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    c.timing = {
        "ms": _time_ms(lambda: ops.flash_attention(q, k, v)),
        "plain_ms": _time_ms(lambda: ops.flash_attention(q, k, v, impl="torch")),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)),
    }
    pairs = b * h * s * (s + 1) / 2
    c.timing["bound_ms"], c.timing["bound_by"] = _bound(
        (2 * b * s * h * d + 2 * b * s * kv * d) * es, 4 * d * pairs)

    # ---- dense decode: (B, KV, G, S, D, dtype, pos); inclusive kpos <= pos
    c = checks["decode_attention"]
    main_pos = [n + MAX_NEW // 2 for n in PROMPT_LENS]
    for b, kv, g, s, d, dt, pos in [
            (4, kvh7, g7, max(main_pos) + 1, d7, bf16, main_pos),
            # a spec round's draft steps: the gathered cache is k + 1 wider
            (4, kvh1, g1, max(main_pos) + spec_k + 1, d1, bf16,
             [x + spec_k for x in main_pos]),
            (3, 2, 4, 100, 64, f32, [0, 50, 99]),
            (2, 4, 8, 333, 128, f32, [1, 332]),
            (2, 8, 1, 65, 32, bf16, [64, 31])]:
        q = rand(b, 1, kv * g, d, dtype=dt)
        kc, vc = rand(b, kv, s, d, dtype=dt), rand(b, kv, s, d, dtype=dt)
        p = ints(pos)
        got = ops.decode_attention(q, kc, vc, p)
        plain = ops.decode_attention(q, kc, vc, p, impl="torch")
        oracle = ref.decode_attention_ref(q[:, 0].reshape(b, kv, g, d), kc, vc, p).reshape(b, 1, kv * g, d)
        what = f"B={b} KV={kv} G={g} S={s} D={d} {dt}"
        c.hold(got, plain, oracle, dt, what)
        # finite poison past pos must leave the output bit-identical
        slots = torch.arange(s, device=cuda)[None, None, :, None] > p[:, None, None, None]
        kp, vp = kc.masked_fill(slots, 1e4), vc.masked_fill(slots, -1e4)
        if not torch.equal(ops.decode_attention(q, kp, vp, p), got):
            raise RuntimeError(f"decode_attention {what}: poison past pos was observed")
    b, kv, g, d = 4, kvh7, g7, d7
    s = max(main_pos) + 1
    q = rand(b, 1, kv * g, d, dtype=bf16)
    kc, vc = rand(b, kv, s, d, dtype=bf16), rand(b, kv, s, d, dtype=bf16)
    p = ints(main_pos)
    mask = torch.arange(s, device=cuda)[None, None, None, :] <= p[:, None, None, None]
    c.timing = {
        "ms": _time_ms(lambda: ops.decode_attention(q, kc, vc, p)),
        "plain_ms": _time_ms(lambda: ops.decode_attention(q, kc, vc, p, impl="torch")),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc, vc, attn_mask=mask, enable_gqa=True)),
    }
    keys = sum(x + 1 for x in main_pos)
    c.timing["bound_ms"], c.timing["bound_by"] = _bound(
        2 * keys * kv * d * es + 2 * b * kv * g * d * es + 4 * b, 4 * d * kv * g * keys)

    # ---- paged decode, through a real PagedKVPool: shared (adopted) pages
    # with refcount > 1, ragged lengths incl. 0, the dump page poisoned
    c = checks["paged_decode_attention"]

    def paged_case(cfg_attn, lengths, share, dt, bs):
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
            kc = rand(1, kv, n - start, d, dtype=dt)
            if n > start:
                pool.scatter_chunk(sid, kc, rand(1, kv, n - start, d, dtype=dt), start)
        if share:
            shared = pool.seq(donor).block_table[: share // bs]
            if min(pool.block_refs(x) for x in shared) < 2:
                raise RuntimeError("paged decode case did not share pages")
        max_len = max(lengths) + 1
        tables = pool.device_tables(sids, pool.blocks_needed(max_len))
        b = len(lengths)
        q = rand(b, 1, kv * g, d, dtype=dt)
        kn, vn = rand(b, 1, kv, d, dtype=dt), rand(b, 1, kv, d, dtype=dt)
        lens = ints(lengths)
        args = (q, pool.k[0], pool.v[0], tables, lens, kn, vn, max_len)
        return pool, args, (b, kv, g, d)

    for attn, lengths, share, dt, bs in [
            (tgt.attn, main_pos, 0, bf16, BLOCK),
            (AttentionConfig(8, 2, 64), [0, 17, 40], 16, f32, 16),
            (AttentionConfig(32, 4, 128), [5, 23, 40, 17], 16, f32, 8),
            (AttentionConfig(8, 8, 32), [33, 1], 0, bf16, 16)]:
        pool, args, (b, kv, g, d) = paged_case(attn, lengths, share, dt, bs)
        q, kpg, vpg, tables, lens, kn, vn, max_len = args
        got = ops.paged_decode_attention(*args)
        plain = ops.paged_decode_attention(*args, impl="torch")
        oracle = ref.paged_decode_attention_ref(
            q[:, 0].reshape(b, kv, g, d), kpg, vpg, tables, lens,
            kn.transpose(1, 2), vn.transpose(1, 2)).reshape(b, 1, kv * g, d)
        c.hold(got, plain, oracle, dt, f"lens={lengths} G={g} D={d} bs={bs} "
                                       f"shared={share} {dt}")
    pool, args, (b, kv, g, d) = paged_case(tgt.attn, main_pos, 0, bf16, BLOCK)
    c.timing = {
        "ms": _time_ms(lambda: ops.paged_decode_attention(*args)),
        "plain_ms": _time_ms(lambda: ops.paged_decode_attention(*args, impl="torch")),
        "library_ms": None,
    }
    keys = sum(main_pos)
    pages = sum(-(-n // BLOCK) for n in main_pos)
    c.timing["bound_ms"], c.timing["bound_by"] = _bound(
        2 * keys * kv * d * es + 4 * b * kv * g * d * es + 4 * (pages + b),
        4 * d * kv * g * (keys + b))
    del pool, args

    # ---- paged prefill: (C, ctx, KV, G, D, bs, dtype); ctx == 0 gets the
    # dump page; rows tiled over several blocks when C * G > 64
    c = checks["paged_prefill_attention"]
    chunk = 256
    main_ctx = max(PROMPT_LENS) - chunk
    for cc, ctx, kv, g, d, bs, dt in [
            (chunk, 0, kvh7, g7, d7, BLOCK, bf16),
            (max(PROMPT_LENS) - chunk, chunk, kvh7, g7, d7, BLOCK, bf16),
            (chunk, 0, kvh1, g1, d1, BLOCK, bf16),
            (max(PROMPT_LENS) - chunk, chunk, kvh1, g1, d1, BLOCK, bf16),
            (37, 13, 2, 4, 64, 8, f32), (20, 0, 4, 8, 128, 16, f32),
            (150, 45, 2, 2, 128, 8, f32), (9, 100, 1, 8, 32, 16, bf16)]:
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
    c.timing = {
        "ms": _time_ms(lambda: ops.paged_prefill_attention(*timed)),
        "plain_ms": _time_ms(lambda: ops.paged_prefill_attention(*timed, impl="torch")),
        "library_ms": None,
    }
    q, _, _, table, ctx, ks, _ = timed
    cc, h, d = q.shape[1], q.shape[2], q.shape[3]
    kv = ks.shape[2]
    c.timing["bound_ms"], c.timing["bound_by"] = _bound(
        (2 * cc * h * d + 2 * (ctx + cc) * kv * d) * es + 4 * table.shape[0],
        4 * d * h * (cc * ctx + cc * (cc + 1) / 2))
    for ck in checks.values():
        log(f"{ck.name}: {ck.cases} cases held; kernel {ck.timing['ms']:.4f} ms, "
            f"plain {ck.timing['plain_ms']:.4f} ms, library {ck.timing['library_ms']}, "
            f"bound {ck.timing['bound_ms']:.4f} ms ({ck.timing['bound_by']})")
        print(f"{ck.name}: largest row-normalised error (vs plain, vs fp32 oracle): "
              + ", ".join(f"{k} {p:.3e}, {o:.3e}" for k, (p, o) in sorted(ck.worst.items())),
              flush=True)
    return checks


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

    def serve(kind, policy, paged):
        """One engine run over the prompts; (engine, finished, wall s)."""
        kw = {}
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
    for kind, policy, paged in runs:
        before = {n: ck.kernel.launches for n, ck in checks.items()}
        eng, done, wall = serve(kind, policy, paged)
        if len(done) != len(prompts) or any(
                len(r.out_tokens) != MAX_NEW or r.status != "ok" for r in done):
            raise RuntimeError(f"{kind}/{policy}: requests did not all finish with "
                               f"{MAX_NEW} tokens: {[len(r.out_tokens) for r in done]}")
        if eng.paged and kind in ("standalone", "dpd") and eng.pool.gather_calls:
            raise RuntimeError(f"{kind}/{policy}: paged run gathered "
                               f"{eng.pool.gather_calls} times")
        used = {n: ck.kernel.launches - before[n] for n, ck in checks.items()}
        ci = GRID_CI["ciso"]
        carbon = sum((request_carbon(u.busy_s, u.energy_j, CHIP_DB[n], ci_g_per_kwh=ci).total_g
                      for n, u in eng.use.items()))
        print(f"engine {kind:10s} {policy:10s} paged={str(eng.paged):5s} wall {wall:.2f} s "
              f"on this card; cost model ({'+'.join(eng.use)}, not measured): clock "
              f"{eng.clock:.4f} s, {carbon * 1e3:.4f} mgCO2; launches {used}", flush=True)
        if eng.rounds:
            log(f"  spec acceptance {eng.acceptance_rate:.3f} over {eng.rounds} rounds")
        del eng
        torch.cuda.empty_cache()
    for ck in checks.values():
        ck.engine_launches = ck.kernel.launches
    idle = [n for n, ck in checks.items() if ck.engine_launches == 0]
    if idle:
        raise RuntimeError(f"kernels never launched on the engine path: {idle}")

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


def main() -> int:
    import torch

    t0 = time.perf_counter()
    card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}", flush=True)
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = phase_kernels(gen)
    phase_engine(checks)
    log(f"total {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(card)
    print(json.dumps({"kernels": [ck.record() for ck in checks.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
