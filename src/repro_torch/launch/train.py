"""Training launcher: elastic, checkpointed training of any registry arch;
the port of src/repro/launch/train.py.

    python -m repro_torch.launch.train --arch llama-300m --full --steps 12
    python -m repro_torch.launch.train --arch yi-6b --device cpu --steps 10
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train --arch yi-6b \\
        --device cpu --model-axis 2 --fail-at 4:2

Full configs (--full) run on the card; reduced ones run anywhere. One
process trains on a (1, 1) mesh; under torchrun (which sets RANK,
WORLD_SIZE, LOCAL_RANK and the rendezvous address) every process is one rank
of a (data, model) mesh, gloo on the CPU and nccl on cards (one card a
rank). --fail-at step:n drops the last n ranks at that step to exercise the
elastic re-mesh and checkpoint restore. Rank 0 prints.
"""
import argparse
import os
import socket
import tempfile


def _parse() -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-axis", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", default=None, help="step:n_ranks to drop")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device):
    """The process group this run trains over: torchrun's (from the
    environment) or a one-rank group on a free local port. gloo on the
    CPU, nccl on cards (each rank on the card LOCAL_RANK names)."""
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    multi = "WORLD_SIZE" in os.environ
    if torch.device(device or "cuda").type == "cuda" and multi:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if multi:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    return dev


def main() -> None:
    args = _parse()
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.training.elastic import ElasticTrainer
    from repro_torch.training.optimizer import AdamWConfig

    dev = init_distributed(args.device)
    try:
        cfg = get_config(args.arch) if args.full else get_reduced_config(args.arch)
        fail_at = None
        if args.fail_at:
            step, n = args.fail_at.split(":")
            fail_at = {int(step): int(n)}
        trainer = ElasticTrainer(
            cfg, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
            opt_cfg=AdamWConfig(lr=args.lr), model_axis=args.model_axis,
            ckpt_every=args.ckpt_every, seed=args.seed, device=str(dev))
        lead = dist.get_rank() == 0
        if lead:
            print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
                  f"on mesh {trainer.mesh_shape} from step {trainer.step}", flush=True)

        def on_step(step, metrics):
            if lead:
                print(f"  step {step:5d} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)

        losses = trainer.run(args.steps, on_step=on_step, fail_at=fail_at)
        if lead:
            print(f"done at step {trainer.step}; final mesh {trainer.mesh_shape}; "
                  f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
