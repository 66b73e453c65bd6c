"""Elastic training demo on the PyTorch port: train a reduced assigned
architecture with checkpointing over 4 ranks, drop 2 of them mid-run, and
watch the trainer re-mesh + restore + continue on the other 2.

    torchrun --standalone --nproc-per-node 4 examples/torch_train_elastic.py --device cpu
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 examples/torch_train_elastic.py

gloo on the CPU (--device cpu), nccl on cards (one card a rank). Rank 0
prints. The JAX example (examples/train_elastic.py) drops 4 of 8 host
devices; here 2 of 4 ranks.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import tempfile  # noqa: E402

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.launch.train import init_distributed  # noqa: E402
from repro_torch.training.elastic import ElasticTrainer  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fail-at", type=int, default=100, help="step at which 2 ranks drop")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--print-every", type=int, default=20)
    args = ap.parse_args()

    dev = init_distributed(args.device)
    try:
        world = dist.get_world_size()
        lead = dist.get_rank() == 0
        cfg = get_reduced_config("glm4-9b", num_layers=2, d_model=256, d_ff=512,
                                 vocab_size=512)
        with tempfile.TemporaryDirectory() as ckpt_dir:
            # every rank writes where rank 0 does: rank 0's directory, sent round
            box = [ckpt_dir]
            dist.broadcast_object_list(box, src=0)
            tr = ElasticTrainer(cfg, batch=8, seq=64, ckpt_dir=box[0],
                                model_axis=2, ckpt_every=args.ckpt_every,
                                opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=20),
                                device=str(dev))
            if lead:
                print(f"mesh {tr.mesh_shape}; training {cfg.name}-reduced "
                      f"({cfg.param_count()/1e6:.1f}M params)", flush=True)

            def on_step(step, m):
                if lead and step % args.print_every == 0:
                    print(f"  step {step:4d}  loss {float(m['loss']):.4f}  "
                          f"mesh {tr.mesh_shape}", flush=True)

            drop = world // 2
            losses = tr.run(args.steps, on_step=on_step, fail_at={args.fail_at: drop})
            if lead:
                print(f"\nsurvived the step-{args.fail_at} failure ({world} -> "
                      f"{world - drop} ranks), mesh now {tr.mesh_shape}")
                print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {tr.step} steps",
                      flush=True)
                assert losses[-1] < losses[0]
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
