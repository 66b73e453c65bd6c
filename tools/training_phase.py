#!/usr/bin/env python3
"""Run chip_smoke.py's `training` phase alone, on one card, without building
or timing the kernels (none is on the training path): a quicker check of
the port's training on the H100 than the whole script.

    python3 tools/training_phase.py        # from the root of a checkout

It prints what the phase prints and a last line `training phase passed on
<card>`; any failure raises.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import paged_attention as pag
    from repro_torch.kernels import rwkv6_wkv as wkv

    card = cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 checks in full fp32
    torch.backends.cudnn.allow_tf32 = False
    # the kernels' launch counters, which the phase holds still
    checks = {n: cs.KernelCheck(n, "", "", k) for n, k in (
        ("flash_attention", fla.KERNEL), ("decode_attention", dec.KERNEL),
        ("paged_decode_attention", pag.DECODE_KERNEL),
        ("paged_prefill_attention", pag.PREFILL_KERNEL),
        ("rwkv6_wkv", wkv.KERNEL), ("mamba2_ssd", ssd.KERNEL))}
    cs.phase_training(checks, card)
    print(f"training phase passed on {card}", flush=True)


if __name__ == "__main__":
    main()
