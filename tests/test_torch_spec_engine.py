"""The port's ServingEngine on the CPU: the speculative kinds spec and dsd.

Greedy token streams must equal the reference engine's on fp32 reduced
configs (2-layer yi-6b target, llama-300m draft), under both batching
policies, with the target's paged path on and off, and the port's paged and
dense runs must agree with each other.
"""
import pytest

from test_torch_engine_cases import POLICIES, port_run, ref_tokens


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("kind", ["spec", "dsd"])
def test_tokens_match_reference_engine(kind, policy, paged):
    want, want_clock = ref_tokens(kind, policy)
    got, eng = port_run(kind, policy, paged)
    assert got == want
    assert eng.clock == want_clock
    assert eng.rounds > 0 and 0.0 <= eng.acceptance_rate <= 1.0


def test_spec_rejects_recurrent_families():
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.core.spec_decode import SpecConfig, spec_decode_round

    cfg = get_reduced_config("rwkv6-7b")
    with pytest.raises(NotImplementedError, match="recurrent"):
        spec_decode_round(None, cfg, {"pos": None}, None, cfg, {"pos": None},
                          torch.zeros(1, dtype=torch.int32), SpecConfig(), torch.Generator())
