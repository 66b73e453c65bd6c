"""Quickstart for the PyTorch port: GreenLLM in ~70 lines.

Builds a small target + draft model with random weights drawn from a
`torch.Generator`, serves a handful of requests through the port's
real-compute engine in each configuration, and prints the carbon ledger -
the paper's whole pipeline (disaggregation, speculative verification, SLO
tracking, Eq. 1-3 accounting). The modelled seconds and carbon are the
cost model's figures for the a100 (new) and t4 / v100 (old) chips, not
measurements of the device that ran the forwards.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions

It runs on the card unless given `--device cpu`, and raises without one.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core.carbon import CHIP_DB, request_carbon
from repro_torch.core.spec_decode import SpecConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    device = resolve_device(ap.parse_args(argv).device)

    def seeded(seed: int) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return gen

    # a small "7B-like" target and a smaller draft (reduced configs: the
    # same code paths run the full architectures on the card), in float32:
    # speculative decoding is exact, and in bf16 a k-token verify rounds
    # differently from k one-token decodes, so greedy streams can part
    target_cfg = get_reduced_config("yi-6b", num_layers=3, dtype="float32")
    draft_cfg = get_reduced_config("yi-6b", num_layers=2, d_model=128,
                                   dtype="float32")
    target = init_params(seeded(0), target_cfg)
    draft = init_params(seeded(1), draft_cfg)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, target_cfg.vocab_size, size=12) for _ in range(6)]

    print(f"{'config':26s} {'tokens':>7s} {'modeled_s':>10s} {'mg CO2':>8s} {'mg/tok':>8s}")
    streams = {}
    for kind, old in (("standalone", None), ("spec", None),
                      ("dpd", "v100"), ("dsd", "t4")):
        eng = ServingEngine(
            target_cfg, target, kind=kind,
            draft_cfg=draft_cfg if kind in ("spec", "dsd") else None,
            draft_params=draft if kind in ("spec", "dsd") else None,
            new_chip="a100", old_chip=old,
            spec=SpecConfig(num_draft_tokens=3), temperature=0.0, seed=0,
            device=device)
        for i, p in enumerate(prompts):
            eng.submit(p, max_new_tokens=16, arrival_s=0.05 * i)
        done = eng.run_until_idle()
        streams[kind] = sorted((r.req_id, tuple(r.out_tokens)) for r in done)
        tokens = sum(len(r.out_tokens) for r in done)
        carbon = sum(
            (request_carbon(u.busy_s, u.energy_j, CHIP_DB[n]) for n, u in eng.use.items()),
            start=request_carbon(0, 0, CHIP_DB["a100"]))
        extra = f"  acceptance={eng.acceptance_rate:.2f}" if eng.rounds else ""
        extra += f"  link={eng.link_bytes/1e6:.2f}MB" if eng.link_bytes else ""
        name = kind + (f"+{old}" if old else "")
        print(f"{name:26s} {tokens:7d} {eng.clock:10.3f} {carbon.total_g*1e3:8.3f} "
              f"{carbon.total_g/tokens*1e3:8.4f}{extra}")
    same = all(s == streams["standalone"] for s in streams.values())
    print(f"\ngreedy outputs of all four configurations token-identical: {same} "
          f"(forwards on {device})")


if __name__ == "__main__":
    main()
