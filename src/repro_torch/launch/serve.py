"""Serving launcher: run the GreenLLM engine end-to-end on the card.

    python -m repro_torch.launch.serve --kind dpd --full
    python -m repro_torch.launch.serve --kind dsd --device cpu

Serves the paper's trio by default: the llama-7b target with a llama-1b
draft for spec/dsd. --full runs their published widths and depths with
random seeded weights; without it the configs are reduced so the whole
pipeline (prefill -> paged KV -> speculative rounds -> verification ->
carbon accounting) runs at CPU scale. --device defaults to cuda and raises
without a card; --device cpu runs the kernels' plain versions. The modelled
time, energy and carbon are the cost model's figures for --new-chip and
--old-chip, not measurements of the device that ran the forwards.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.carbon import GRID_CI
from repro_torch.core.spec_decode import SpecConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.workload import DATASETS, sample_requests


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama-7b")
    ap.add_argument("--draft-arch", default="llama-1b")
    ap.add_argument("--kind", default="dsd",
                    choices=["standalone", "spec", "dpd", "dsd"])
    ap.add_argument("--dataset", default="sharegpt", choices=list(DATASETS))
    ap.add_argument("--qps", type=float, default=2.0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--new-chip", default="a100")
    ap.add_argument("--old-chip", default="t4")
    ap.add_argument("--grid", default="ciso", choices=list(GRID_CI))
    ap.add_argument("--full", action="store_true",
                    help="use the full config (card-scale; not for CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    device = resolve_device(args.device)

    def seeded(seed: int) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return gen

    get_cfg = get_config if args.full else get_reduced_config
    tcfg = get_cfg(args.arch)
    needs_draft = args.kind in ("spec", "dsd")
    dcfg = None
    dparams = None
    if needs_draft:
        dcfg = get_cfg(args.draft_arch)
        if not args.full:
            import dataclasses

            dcfg = dataclasses.replace(dcfg, name=dcfg.name + "-draft", d_ff=128)
        dparams = init_params(seeded(args.seed + 1), dcfg)
    tparams = init_params(seeded(args.seed), tcfg)

    engine = ServingEngine(
        tcfg, tparams, kind=args.kind, draft_cfg=dcfg, draft_params=dparams,
        spec=SpecConfig(num_draft_tokens=args.spec_k),
        new_chip=args.new_chip,
        old_chip=args.old_chip if args.kind in ("dpd", "dsd") else None,
        temperature=args.temperature, seed=args.seed, device=device)

    ds = DATASETS[args.dataset]
    rng = np.random.default_rng(args.seed)
    t_wall = time.time()
    for i in range(args.requests):
        plen = int(np.clip(rng.lognormal(np.log(ds.p50[0]), 0.4), 4, 64))
        prompt = rng.integers(0, tcfg.vocab_size, size=plen)
        engine.submit(prompt, max_new_tokens=args.max_new, arrival_s=i / args.qps)
    done = engine.run_until_idle()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_wall = time.time() - t_wall

    ci = GRID_CI[args.grid]
    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"\n=== {args.kind}, cost model for {args.new_chip}"
          + (f"+{args.old_chip}" if args.kind in ("dpd", "dsd") else "")
          + f", forwards on {device} ===")
    print(f"requests: {len(done)}  output tokens: {total_tokens}  wall: {t_wall:.1f}s")
    print(f"modeled time: {engine.clock:.3f}s")
    for name, use in engine.use.items():
        print(f"  {name}: busy {use.busy_s:.3f}s energy {use.energy_j:.1f}J")
    if engine.rounds:
        print(f"speculative acceptance (measured): {engine.acceptance_rate:.3f} "
              f"over {engine.rounds} rounds")
    if engine.link_bytes:
        print(f"interconnect traffic: {engine.link_bytes/1e6:.2f} MB")
    ttfts = [r.ttft_s for r in done]
    tpots = [r.tpot_s for r in done if len(r.out_tokens) > 1]
    print(f"TTFT mean {np.mean(ttfts)*1e3:.1f}ms  TPOT mean {np.mean(tpots)*1e3:.2f}ms "
          f"(SLO: {ds.ttft_slo_s*1e3:.0f}/{ds.tpot_slo_s*1e3:.0f} ms)")
    from repro_torch.core.carbon import CHIP_DB, request_carbon

    total = sum(
        (request_carbon(u.busy_s, u.energy_j, CHIP_DB[n], ci_g_per_kwh=ci)
         for n, u in engine.use.items()),
        start=request_carbon(0, 0, CHIP_DB[args.new_chip]))
    print(f"carbon: {total.total_g*1e3:.3f} mg total "
          f"({total.operational_g*1e3:.3f} op + {total.embodied_g*1e3:.3f} emb) "
          f"= {total.total_g/max(total_tokens,1)*1e3:.4f} mg/token @ {ci:.0f} gCO2/kWh")


if __name__ == "__main__":
    main()
