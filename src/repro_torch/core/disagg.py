"""Disaggregation executors: the paper's component ① (§4.1).

Formalizes the two optimizers over a (new pool, old pool, interconnect)
triple and provides the standard configuration catalog the SLO-aware
scheduler searches over (§7.1):

    Standalone        target on new chip only (the carbon baseline)
    SpecDecode        colocated speculative decoding on the new chip
    DPD new+old       prefill on new, decode on old (KV crosses the link)
    DSD new+old+draft draft on old, target+verifier on new

`dsd_round_time` is the single source of truth for the Fig. 7
communication-overlap schedule, shared by the simulator and the engine.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig
from repro_torch.serving.perfmodel import Interconnect, dsd_round_time  # noqa: F401 (re-export)
from repro_torch.serving.simulator import ServingMode


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """A fully-resolved serving configuration (mode + models + placement)."""

    mode: ServingMode
    target: ModelConfig
    draft: Optional[ModelConfig] = None

    @property
    def name(self) -> str:
        return self.mode.name


# Per-draft-model acceptance rates (profiled; the real-compute engine
# measures these end-to-end - serving/engine.py:acceptance_rate). Larger
# drafts track the target better.
DEFAULT_ACCEPTANCE = {"llama-1b": 0.7, "llama-300m": 0.55}


def standard_catalog(
    target: str = "llama-7b",
    drafts: tuple[str, ...] = ("llama-1b", "llama-300m"),
    new_chip: str = "a100",
    old_chips: tuple[str, ...] = ("t4", "v100"),
    interconnect: Interconnect = Interconnect(),
    spec_k: int = 4,
    acceptance: dict[str, float] | float | None = None,
) -> list[DisaggConfig]:
    """The paper's §7.1 configuration list (the scheduler's matrix columns)."""
    if acceptance is None:
        acceptance = DEFAULT_ACCEPTANCE
    acc = (lambda d: acceptance) if isinstance(acceptance, float) else \
        (lambda d: acceptance.get(d, 0.7))
    tcfg = get_config(target)
    out = [
        DisaggConfig(ServingMode("standalone", "standalone", new_chip,
                                 interconnect=interconnect), tcfg)
    ]
    for d in drafts:
        out.append(DisaggConfig(
            ServingMode(f"spec-{d}", "spec", new_chip, spec_k=spec_k,
                        acceptance=acc(d), interconnect=interconnect),
            tcfg, get_config(d)))
    for old in old_chips:
        out.append(DisaggConfig(
            ServingMode(f"dpd-{old}", "dpd", new_chip, old,
                        interconnect=interconnect), tcfg))
        for d in drafts:
            out.append(DisaggConfig(
                ServingMode(f"dsd-{old}-{d}", "dsd", new_chip, old, spec_k=spec_k,
                            acceptance=acc(d), interconnect=interconnect),
                tcfg, get_config(d)))
    return out
