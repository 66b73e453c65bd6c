"""Weights from the seed, made on the card by the benchmark: what every
family's `make_weights` (perfbench/families) shares.

One stacked tensor a kind of weight (all layers of it together), filled on
the device by a `torch.Generator` seeded with the run's seed, in the type the
model is served in: bf16 projections, fp32 norm gains and router (as the
program keeps them). A family's `program_params` hands the program views of
these tensors in its parameter layout; the plain reference reads the same
tensors.
"""
from __future__ import annotations

import torch

SEED_MOD = 2 ** 63


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    return gen


def normal(gen, shape, std, dtype, device, mean=0.0):
    t = torch.empty(shape, dtype=dtype, device=device)
    for piece in (t if t.dim() >= 3 else [t]):       # one call a layer
        piece.normal_(mean, std, generator=gen)
    return t
