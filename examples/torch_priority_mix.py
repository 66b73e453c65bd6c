"""Walkthrough: SLO-class-aware scheduling on a mixed-class stream.

One a100 replica serves an overloaded ShareGPT stream in which every
request carries an SLO class (workload.SLO_CLASSES):

  tight      latency-critical chat turns: half the dataset's TTFT/TPOT
             budget, scheduler priority 0
  standard   the dataset's own Table-2 targets (priority 1)
  relaxed    batch-y background work: 5x TTFT / 2x TPOT slack, priority 2

The SAME physical stream (identical arrivals and sizes - the class
sampler draws from a dedicated rng) is served twice: class-blind (every
request standard) and class-aware. The priority scheduler
(serving/batching.py) admits tight prefills first, composes decode slots
shortest-remaining-first within class, preempts relaxed blocks for tight
arrivals, and ages waiting work so nothing starves - watch tight mean
TTFT drop by an order of magnitude while relaxed pays with its slack.

Then the provisioning half: `build_gpu_info(slo_class=...)` gates each
class's capacity on its own targets and load factor, and the stacked
class-aware allocation (benchmarks/priority_sweep.py) provisions fewer
instances than treating all traffic as tight - at matched per-class SLO
attainment.

Run:  PYTHONPATH=src python examples/torch_priority_mix.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving.batching import BatchPolicy  # noqa: E402
from repro_torch.serving.simulator import ServingMode, simulate  # noqa: E402
from repro_torch.serving.workload import (  # noqa: E402
    DATASETS,
    DEFAULT_CLASS_MIX,
    Request,
    SLO_CLASSES,
    sample_mixture_requests,
    slo_targets,
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--qps", type=float, default=16.0,
                    help="overload the replica so priorities matter")
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--age-steps", type=int, default=512,
                    help="scheduler steps per one-level aging promotion")
    args = ap.parse_args()

    ds = DATASETS["sharegpt"]
    cfg = get_config("llama-7b")
    mode = ServingMode("standalone", "standalone", "a100")
    reqs = sample_mixture_requests(ds, args.qps, args.duration, seed=3,
                                   class_mix=DEFAULT_CLASS_MIX)
    n_by_class = {c: sum(r.slo_class == c for r in reqs) for c in SLO_CLASSES}
    print(f"{len(reqs)} requests at {args.qps:g} QPS: " +
          ", ".join(f"{v} {k}" for k, v in n_by_class.items()))
    for c in SLO_CLASSES:
        tt, tp = slo_targets(ds, c)
        print(f"  {c:9s} targets: TTFT {tt*1e3:7.0f} ms  TPOT {tp*1e3:5.0f} ms"
              f"  (priority {SLO_CLASSES[c].priority})")

    pol = BatchPolicy(age_steps=args.age_steps)
    aware = simulate(mode, cfg, reqs, seed=7, batching=pol)
    blind = simulate(mode, cfg,
                     [Request(r.req_id, r.arrival_s, r.prompt_len,
                              r.output_len) for r in reqs],
                     seed=7, batching=pol)

    print(f"\n{'class':9s} {'blind TTFT':>11s} {'aware TTFT':>11s} "
          f"{'blind att':>10s} {'aware att':>10s}")
    ids = {c: {r.req_id for r in reqs if r.slo_class == c}
           for c in SLO_CLASSES}

    def mean_ttft(res, rid_set):
        return float(np.mean([t.ttft_s for t in res.traces
                              if t.req.req_id in rid_set]))

    for c in SLO_CLASSES:
        # judge the class-blind run against the class's own targets too:
        # same requests, same promises - only the scheduler differs
        b_att = sum(
            1 for t in blind.traces if t.req.req_id in ids[c]
            and t.ttft_s <= slo_targets(ds, c)[0]
            and t.tpot_s <= slo_targets(ds, c)[1]) / max(len(ids[c]), 1)
        print(f"{c:9s} {mean_ttft(blind, ids[c])*1e3:9.0f} ms "
              f"{mean_ttft(aware, ids[c])*1e3:9.0f} ms "
              f"{b_att:10.3f} {aware.slo_attainment(ds, slo_class=c):10.3f}")
    print("\nthe tight class buys its TTFT back from the relaxed class's "
          "slack;\nbenchmarks/priority_sweep.py turns the same slack into "
          "provisioned-carbon savings.")


if __name__ == "__main__":
    main()
