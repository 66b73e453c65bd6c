"""Run one benchmark cell once on the card and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s): the kernels loaded (built into build/repro_torch
on a checkout's first run), the weights made on the card from the seed, the
engine, a warm-up over the shapes the cell's traffic uses, and the lead-in
load the cell's file asks for. Then the window: `--seconds` of open-loop
traffic through repro_torch's ServingEngine. After it, the plain reference
judges a sample of what was served, and the last line of standard output is
one JSON object: correct, attempted, failed, metrics, device (and with
--trace 1 breakdown), then checks.

--trace 0 reports the cell's end-to-end metrics; --trace 1 profiles a part
of the window and reports the per-layer metrics. Without a CUDA card, or
with fewer cards than the cell needs, it exits with code 3 and prints no
result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 6.0          # seconds at the window's end a --trace 1 run profiles
SAMPLE = 8             # requests the reference judges
NO_READING = 1e30     # a gap when nothing could be judged: fails every limit


def use_checkout_caches() -> None:
    """Keep every compiler cache in fixed directories inside the checkout
    (the program's kernels build into build/repro_torch by themselves).
    Call before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def serve(cell, seed: int, seconds: float, trace: bool, t_start: float = T_START,
          device: str = "cuda:0", weights: dict | None = None):
    """Set up, run the window, read the metrics' inputs. Returns (view,
    weights, served requests) with the engine freed. `weights` reuses those
    an earlier call returned (the sweep). device="cpu" runs the program's
    plain versions (the CPU tests); no energy or kernels there."""
    import numpy as np
    import torch

    from perfbench.harness import drive, trace as tr
    from perfbench.harness.nvml import Nvml, card_uuid
    from perfbench.traffic.generator import generate
    from repro_torch.kernels import paged_attention as pa

    cfg, mix, prm, fam = cell.config, cell.mix, cell.params, cell.family
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    nv, power_w = None, None
    if cuda:
        from repro_torch.kernels import build
        try:
            nv = Nvml(card_uuid(dev.index or 0))
            power_w = nv.power_limit_w()
        except (OSError, RuntimeError) as e:
            log(f"NVML unavailable ({e}); energy_j_per_token is not read")
            nv = None
        build.build_all(fam.KERNELS)
    lead = float(prm.get("lead_s", 0.0))
    reqs = generate(mix, seed, cfg["vocab_size"], horizon_s=lead + seconds,
                    rate=float(prm.get("rate", 0.0)))
    w = fam.make_weights(cfg, seed, dev) if weights is None else weights
    eng = drive.build_engine(fam.model_config(cfg), cfg, fam.program_params(w, cfg), prm,
                             seed, dev)
    warm = drive.warm_up(eng, mix, cfg["vocab_size"], prm["max_batch"],
                         np.random.default_rng([int(seed) % 2 ** 63, 0x3A7E]))
    sync()
    loop = drive.OpenLoop(eng, reqs, t0=drive.now())
    loop.run_until(lead)
    t_open, waiting_open = loop.now(), loop.waiting()
    setup_s = time.perf_counter() - t_start
    e0 = nv.energy_mj() if nv else None
    trace_view, launches, traced = None, {}, (0.0, 0.0)
    close = lead + seconds
    if trace:
        # the profiled span ends the window: starting the profiler pauses
        # the open loop for seconds (its first use in the process), so the
        # host-clock metrics read the steady steps before it, and the span
        # runs its full length from the start, past the close if need be
        from torch.profiler import ProfilerActivity, profile
        span = min(TRACE_S, seconds / 2)
        loop.observe = True
        loop.run_until(close - span)
        sync()
        # device activity only: recording every host op as well slows the
        # engine's host-bound step several times over
        prof = profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
        n0 = (pa.DECODE_KERNEL.launches, pa.PREFILL_KERNEL.launches)
        prof.start()
        h0 = loop.now()
        close = max(close, h0 + span)
    loop.run_until(close)
    if trace:
        sync()
    t_end, waiting_close = loop.now(), loop.waiting()
    if trace:
        prof.stop()
        launches = {"decode": pa.DECODE_KERNEL.launches - n0[0],
                    "prefill": pa.PREFILL_KERNEL.launches - n0[1]}
        trace_view = tr.read(prof, t_end - h0)
        traced = (h0, t_end)
        del prof
    energy_j = (nv.energy_mj() - e0) / 1e3 if nv else None
    sync()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if nv:
        nv.close()
    late = sorted(loop.late)
    # what the metric readers see of the run
    view = types.SimpleNamespace(
        cfg=cfg, mix=mix, params=prm, requests=loop.served, t_open=t_open, t_due0=lead,
        t_close=lead + seconds, t_end=t_end, setup_s=setup_s, energy_j=energy_j,
        trace=trace_view, obs=loop.obs, traced=traced, launches=launches, peak=peak,
        power_w=power_w, warm_steps=warm, steps=loop.step_idx,
        late_max_s=late[-1] if late else 0.0, late_p50_s=late[len(late) // 2] if late else 0.0,
        waiting_open=waiting_open, waiting_close=waiting_close,
        pool_blocks=eng.pool.num_blocks, peak_blocks=loop.peak_blocks,
        block_bytes=eng.pool.k[:, 0].numel() * eng.pool.k.element_size() * 2)
    served = loop.served
    del loop, eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return view, w, served


def judged_checks(cell, view, w, served, seed: int) -> tuple[dict, dict]:
    """({name: [value, limit]}, readings) of the comparison with the
    reference, for each limit in the cell's `checks`: judged_tokens is a
    floor, every other number a ceiling."""
    from perfbench.harness import check
    limits = cell.params["checks"]
    sample = check.sample([s for s in served if s.times and s.times[-1] >= view.t_open],
                          seed, SAMPLE)
    r = {"failed_requests": sum(1 for s in served if s.failed),
         "judged_tokens": sum(len(s.times) for s in sample)}
    try:
        if sample:
            r.update(check.judge(cell.family, w, cell.config, served, sample))
    except check.JudgeError as e:
        log(f"reference: {e}")
    return {k: [r.get(k, NO_READING), lim] for k, lim in limits.items()}, r


def passed(checks: dict) -> bool:
    return all(v >= lim if k == "judged_tokens" else v <= lim
               for k, (v, lim) in checks.items())


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda:0"):
    """One run of a cell: the result object, or None when a module that must
    not load is loaded (named on standard error)."""
    import torch

    from perfbench.harness import spec

    view, w, served = serve(cell, seed, seconds, trace, device=device)
    bad = forbidden_modules()
    if bad:
        log(f"modules that must not load are loaded: {bad}; no result")
        return None
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m.name)(view)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    due = [s for s in served if view.t_due0 <= s.due_s < view.t_close]
    started = [s for s in served if s.times or s.failed]
    poisson = cell.mix["arrivals"] == "poisson"
    attempted = len(due) if poisson else len(started)
    missing = sum(1 for s in due if not s.times) if poisson else 0
    log(f"generator: {len(view.requests)} requests, submit late by p50 "
        f"{view.late_p50_s * 1e3:.3f} ms, max {view.late_max_s * 1e3:.3f} ms; "
        f"{view.steps} steps in the run, {view.warm_steps} in warm-up; "
        f"{attempted} attempted, {missing} missing at the close")
    checks, readings = judged_checks(cell, view, w, served, seed)
    del w
    log(f"reference readings: {json.dumps(readings)}")
    kv_pool = {"blocks": view.pool_blocks, "peak_blocks_used": view.peak_blocks,
               "peak_used_share": view.peak_blocks / view.pool_blocks,
               "peak_used_bytes": view.peak_blocks * view.block_bytes}
    log(f"kv pool: {json.dumps(kv_pool)}")
    cuda = torch.device(device).type == "cuda"
    device_out = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu",
                  "count": cell.chips, "memory_peak_bytes": view.peak}
    out = {"correct": passed(checks), "attempted": attempted,
           "failed": sum(1 for s in started if s.failed), "metrics": metrics,
           "device": device_out, "power_limit_w": view.power_w, "kv_pool": kv_pool}
    if trace:
        device_out["busy_s"] = view.trace.busy_s
        device_out["window_s"] = view.trace.window_s
        out["breakdown"] = {"device_ops": view.trace.device_ops,
                            "idle_gaps": view.trace.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k} {v} limit {lim}")
    return out


def main(argv=None) -> int:
    args = parse(argv)
    use_checkout_caches()
    import torch

    from perfbench.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    # the reference judged after run_cell's look: look again before printing
    bad = forbidden_modules()
    if out is None or bad:
        if bad:
            log(f"modules that must not load are loaded: {bad}; no result")
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
