"""The port's ServingEngine serving the moe family under the continuous
policy, on the CPU: standalone on the paged path and on the dense (gather)
path against the reference's engine on reduced qwen2-moe-a2.7b (fp32, 2
layers, the reference's weights bridged); dpd is in
tests/test_torch_family_engine.py. The
greedy streams and the modelled clock must be equal. A continuous MoE
prefill recomputes the whole prefix on both paths: capacity routing is per
group of tokens, so a chunk alone would route otherwise.
"""
import pytest

from _torch_family_cases import NEW_TOKENS, port_run, ref_run


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_moe_continuous_tokens_match_reference_engine(paged):
    want, want_clock = ref_run("qwen2-moe-a2.7b", "standalone", "continuous")
    got, eng = port_run("qwen2-moe-a2.7b", "standalone", "continuous", paged)
    assert got == want
    assert eng.clock == want_clock
    assert eng.paged is paged
    assert all(len(t) == NEW_TOKENS for t in got.values())
    if paged:
        assert eng.pool.gather_calls == 0, "paged decode must be gather-free"
