#!/usr/bin/env python3
"""The sharded train step on a (data 2, model 2) mesh of 4 ranks against the
unsharded train_step, two steps on the same weights and batches, at
llama-300m's widths cut to 2 layers in fp32 (its 16 kv heads shard over
"model", so attention runs on each rank's own heads).

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 tools/sharded_step_check.py
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 tools/sharded_step_check.py cpu
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 tools/sharded_step_check.py [cpu] sp

One card a rank (nccl) by default, or CPU processes (gloo). With `sp` the
step runs with the sequence-parallel residual stream (carry_spec
(("data",), "model", None)), and a second check runs reduced qwen2-moe
(4 experts, fp32) with it and the expert-parallel dispatch (ep_axes
("data",)), 8 x 128 tokens in groups of 32 (32 groups, on the data axis).
Rank 0 prints, per check, the placements of one kv projection, both losses
a step, the first batch's gradients' largest difference relative to the
plain ones' largest value (leaf by leaf), and the params' largest
difference (in units of lr) and the share off by more than 0.1 lr.
"""
import copy
import dataclasses
import os
import sys

import torch
import torch.distributed as dist


def check(name, cfg, ex, batch, seq, dev, mesh) -> None:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import backbone
    from repro_torch.training import train_step as ts
    from repro_torch.training.data import DataPipeline
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_leaves

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = backbone.init_params(gen, cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    ref_p, ref_o = copy.deepcopy(params), init_opt_state(params)
    sp = ts.shard_params(params, mesh)
    so = ts.shard_opt_state(init_opt_state(params), params, mesh)
    step = ts.make_sharded_train_step(mesh, cfg, opt, ex)
    plain = DataPipeline(cfg, batch=batch, seq=seq, device=str(dev), dtype=torch.float32)
    placed = DataPipeline(cfg, mesh, batch=batch, seq=seq, dtype=torch.float32)
    with implicit_replication():
        _, gg = ts.loss_and_grads(sp, next(placed), cfg, ex)
    _, wg = ts.loss_and_grads(ref_p, next(plain), cfg, ex)
    grad = max(float((g.full_tensor() - w).abs().max() / w.abs().max())
               for w, g in zip(tree_leaves(wg), tree_leaves(gg)))
    placed.seek(0)
    plain.seek(0)
    losses = []
    for _ in range(2):
        ref_p, ref_o, rm = ts.train_step(ref_p, ref_o, next(plain), cfg, opt, ex)
        sp, so, m = step(sp, so, next(placed))
        losses.append((float(m["loss"]), float(rm["loss"])))
    d = [(a - b.full_tensor()).abs() / opt.lr for a, b in zip(tree_leaves(ref_p), tree_leaves(sp))]
    if dist.get_rank() == 0:
        wk = sp["layers"][0]["attn"]["wk"]
        print(f"{name}: wk placements {[str(p) for p in wk.placements]}, losses (sharded, "
              f"unsharded) {losses}, gradients max diff {grad:.3e} of the largest, params max "
              f"diff {max(float(x.max()) for x in d):.3f} lr, "
              f"{sum(int((x > 0.1).sum()) for x in d) / sum(x.numel() for x in d):.3e} "
              f"off by more than 0.1 lr", flush=True)


def main() -> None:
    args = sys.argv[1:]
    dev_type = "cpu" if "cpu" in args else "cuda"
    seq_parallel = "sp" in args
    if dev_type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo")
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import TRAIN_EXEC

    dev = (torch.device("cuda", torch.cuda.current_device()) if dev_type == "cuda"
           else torch.device("cpu"))
    mesh = make_host_mesh(2, 2, device_type=dev_type)
    ex = TRAIN_EXEC
    if seq_parallel:
        ex = dataclasses.replace(ex, carry_spec=(("data",), "model", None))
    what = f"sharded (2, 2) on {dev_type}{', sequence-parallel' if seq_parallel else ''}"
    cfg = dataclasses.replace(get_config("llama-300m"), num_layers=2, dtype="float32")
    check(f"{what}, llama-300m (2 layers)", cfg, ex, 8, 128, dev, mesh)
    if seq_parallel:
        moe = get_reduced_config("qwen2-moe-a2.7b", dtype="float32")
        check(f"{what}, expert-parallel over data, reduced qwen2-moe", moe,
              dataclasses.replace(ex, ep_axes=("data",), moe_group_size=32), 8, 128, dev, mesh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
