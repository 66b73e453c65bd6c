"""Readings that set a cell's correctness limit: for each seed, one run of
the cell (set-up, lead-in, window, as run.py does), then the plain reference
over the judged requests, and the control, the same reference computed in
fp8, at the same positions. One JSON line a seed.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

The control is judged as the program is: the gap by which its first choice
lies below the fp32 reference's best. It must fail the limit that the
program's runs pass.
"""
import json
import sys
import time

import run


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dtype", help="serve in this type instead of the config's (a witness)")
    p.add_argument("--layers", type=int, help="keep this many layers (a witness)")
    p.add_argument("--pool-blocks", type=int, help="KV pool blocks (a witness)")
    args = p.parse_args(argv)
    run.use_checkout_caches()
    import torch

    from perfbench.harness import check, spec
    cell = spec.load_cell(args.workload)
    for key, val in (("torch_dtype", args.dtype), ("num_hidden_layers", args.layers)):
        if val is not None:
            cell.config[key] = val
    if args.pool_blocks is not None:
        cell.config["engine"]["pool_blocks"] = args.pool_blocks
    if not torch.cuda.is_available():
        run.log("no CUDA card: no readings")
        return 3
    for seed in args.seeds:
        t0 = time.perf_counter()
        view, w, served = run.serve(cell, seed, args.seconds, False, t_start=t0)
        sample = check.sample([s for s in served if s.times and s.times[-1] >= view.t_open],
                              seed, run.SAMPLE)
        t1 = time.perf_counter()
        if not sample:
            print(json.dumps({"seed": seed, "judged": 0}), flush=True)
            continue
        r = check.judge(cell.family, w, cell.config, served, sample, control=True)
        r.update(seed=seed, served_requests=sum(1 for s in served if s.times),
                 run_s=t1 - t0, judge_s=time.perf_counter() - t1,
                 memory_peak_bytes=view.peak)
        print(json.dumps(r), flush=True)
        del w, served, view
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
