"""Find a fixed-rate cell's knee: its traffic at a list of rates, one after
the other in one process, each a run of the cell (`run.serve`) at that rate
on a fresh engine over the same weights.

    python3 perfbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates <r> [<r> ...]

For each rate, after the cell's lead-in, one line: the output tokens/s
completed against those offered, the TTFT and TPOT 95th percentiles (the
cell's own metric readers), the requests waiting for their first token when
the window opens and when it closes, and the share of requests due in the
window that met both of the mix's limits (Table 2; a request that failed or
has no first token meets none). The knee is the highest rate at which
completed output keeps up with the offered and the waiting queue does not
grow through the window.
"""
import dataclasses
import json
import sys

import run


def attainment(view) -> float | None:
    """Share of the requests due in the window that met both limits."""
    from perfbench.harness.stats import due_in_window
    due = due_in_window(view)
    ttft_lim, tpot_lim = view.mix["ttft_limit_s"], view.mix["tpot_limit_s"]
    met = sum(1 for s in due if s.times and not s.failed
              and s.times[0] - s.due_s <= ttft_lim
              and (len(s.times) < 2
                   or (s.times[-1] - s.times[0]) / (len(s.times) - 1) <= tpot_lim))
    return met / len(due) if due else None


def rows(cell, seed: int, seconds: float, rates, device: str = "cuda:0"):
    """One row (a dict) for each rate, in order."""
    from perfbench.harness import spec
    from perfbench.harness.stats import due_in_window
    from perfbench.traffic.generator import mean_output
    w = None
    for rate in rates:
        at_rate = dataclasses.replace(cell, params=dict(cell.params, rate=rate))
        view, w, _ = run.serve(at_rate, seed, seconds, False, device=device, weights=w)
        row = {"rate": rate, "due": len(due_in_window(view)),
               "offered_tokens_per_s": rate * mean_output(cell.mix)}
        for name in ("output_tokens_per_s", "ttft_p95_ms", "tpot_p95_ms"):
            row[name] = spec.reader(name)(view)
        row.update(waiting_open=view.waiting_open, waiting_close=view.waiting_close,
                   attainment=attainment(view), steps=view.steps,
                   late_max_ms=1e3 * view.late_max_s)
        yield row


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    run.use_checkout_caches()
    import torch

    from perfbench.harness import spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        run.log("no CUDA card: no sweep")
        return 3
    for row in rows(cell, args.seed, args.seconds, args.rates):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
