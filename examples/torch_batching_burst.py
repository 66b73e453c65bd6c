"""Walkthrough: iteration-level continuous batching under a burst.

One a100 replica serves a ShareGPT stream that bursts from 2 to 22 QPS,
twice, under the two scheduler policies (serving/batching.py):

  serialized   the legacy executor - one whole prompt prefilled at a time
               with priority, every decode stalled behind it
  continuous   vLLM/Sarathi-style hybrid steps: prefill *chunks* + decode
               tokens share each iteration (and its weight read) under a
               token budget, KV admission is block-granular

Watch p99 TTFT: during the burst the serialized engine's prefill queue
drains one prompt per weight read while the continuous engine packs 2-3
prompts' chunks into each step - tail TTFT drops by ~40% at BETTER SLO
attainment. Then try `--policy` knobs: shrink `chunk_tokens` and TPOT
tightens further (smaller stalls) while TTFT pays more weight re-reads.

Run:  PYTHONPATH=src python examples/torch_batching_burst.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving.batching import BatchPolicy  # noqa: E402
from repro_torch.serving.simulator import ServingMode, simulate  # noqa: E402
from repro_torch.serving.workload import DATASETS, sample_piecewise_requests  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--burst-qps", type=float, default=22.0)
    ap.add_argument("--low-qps", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=40.0)
    ap.add_argument("--chunk-tokens", type=int, default=256)
    ap.add_argument("--token-budget", type=int, default=512)
    args = ap.parse_args()

    ds = DATASETS["sharegpt"]
    cfg = get_config("llama-7b")
    mode = ServingMode("standalone", "standalone", "a100")
    d = args.duration
    profile = [(0.0, args.low_qps), (d / 4, args.burst_qps),
               (d / 2, args.low_qps), (3 * d / 4, args.burst_qps)]
    reqs = sample_piecewise_requests(ds, profile, d, seed=0)
    print(f"{len(reqs)} requests, bursts of {args.burst_qps:g} QPS over "
          f"troughs of {args.low_qps:g} QPS ({d:g}s horizon)\n")

    policies = {
        "serialized": "serialized",
        "continuous": BatchPolicy(chunk_tokens=args.chunk_tokens,
                                  token_budget=args.token_budget),
    }
    print(f"{'policy':12s} {'p50 TTFT':>9s} {'p99 TTFT':>9s} "
          f"{'mean TPOT':>10s} {'SLO att':>8s}")
    for name, pol in policies.items():
        res = simulate(mode, cfg, reqs, seed=1, batching=pol)
        ttfts = [t.ttft_s for t in res.traces]
        print(f"{name:12s} {np.percentile(ttfts, 50):8.3f}s "
              f"{np.percentile(ttfts, 99):8.3f}s "
              f"{res.mean_tpot() * 1e3:8.1f}ms "
              f"{res.slo_attainment(ds):8.3f}")
    print("\nDuring each burst the serialized prefill queue stalls decodes "
          "whole-prompt-at-a-time;\nhybrid chunked steps share one weight "
          "read between the queue and the running batch.")


if __name__ == "__main__":
    main()
