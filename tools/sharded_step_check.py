#!/usr/bin/env python3
"""The sharded train step on a (data 2, model 2) mesh of 4 ranks against the
unsharded train_step, two steps on the same weights and batches, at
llama-300m's widths cut to 2 layers in fp32 (its 16 kv heads shard over
"model", so attention runs on each rank's own heads).

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 tools/sharded_step_check.py
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 tools/sharded_step_check.py cpu

One card a rank (nccl) by default, or CPU processes (gloo). Rank 0 prints
the placements of one kv projection, both losses a step, and the params'
largest difference (in units of lr) and the share off by more than 0.1 lr.
"""
import copy
import dataclasses
import os
import sys

import torch
import torch.distributed as dist


def main() -> None:
    dev_type = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if dev_type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo")
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import backbone
    from repro_torch.models.layers import TRAIN_EXEC
    from repro_torch.training import train_step as ts
    from repro_torch.training.data import DataPipeline
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_leaves

    dev = (torch.device("cuda", torch.cuda.current_device()) if dev_type == "cuda"
           else torch.device("cpu"))
    cfg = dataclasses.replace(get_config("llama-300m"), num_layers=2, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = backbone.init_params(gen, cfg)
    mesh = make_host_mesh(2, 2, device_type=dev_type)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    ref_p, ref_o = copy.deepcopy(params), init_opt_state(params)
    sp = ts.shard_params(params, mesh)
    so = ts.shard_opt_state(init_opt_state(params), params, mesh)
    step = ts.make_sharded_train_step(mesh, cfg, opt, TRAIN_EXEC)
    plain = DataPipeline(cfg, batch=8, seq=128, device=str(dev), dtype=torch.float32)
    placed = DataPipeline(cfg, mesh, batch=8, seq=128, dtype=torch.float32)
    losses = []
    for _ in range(2):
        ref_p, ref_o, rm = ts.train_step(ref_p, ref_o, next(plain), cfg, opt, TRAIN_EXEC)
        sp, so, m = step(sp, so, next(placed))
        losses.append((float(m["loss"]), float(rm["loss"])))
    d = [(a - b.full_tensor()).abs() / opt.lr for a, b in zip(tree_leaves(ref_p), tree_leaves(sp))]
    if dist.get_rank() == 0:
        wk = sp["layers"][0]["attn"]["wk"]
        print(f"sharded (2, 2) on {dev_type}: wk placements {[str(p) for p in wk.placements]}, "
              f"losses (sharded, unsharded) {losses}, params max diff "
              f"{max(float(x.max()) for x in d):.3f} lr, "
              f"{sum(int((x > 0.1).sum()) for x in d) / sum(x.numel() for x in d):.3e} "
              f"off by more than 0.1 lr", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
