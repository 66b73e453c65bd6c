"""The port's device rule: entry points run on the card unless the caller
asks for the CPU by name, and never carry on quietly on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means the card (`cuda`); a CUDA device without a card raises.
    A bare `cuda` resolves to the current card's index, so it compares
    equal to the device of a tensor placed there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run its plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
