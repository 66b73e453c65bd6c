"""The port's ServingEngine serving the moe family, on the CPU: standalone
under the serialized policy, dpd, and the launcher.

Reduced qwen2-moe-a2.7b (fp32, 2 layers, 4 experts top-2 plus a shared
expert) goes through the reference's engine and the port's with the
reference's weights bridged: standalone serialized on the paged path and on
the dense (gather) path, and dpd continuous on the paged path. The greedy
streams must be equal, and the modelled clock too (the shared cost model
over the same schedule). MoE is the one family beyond the dense Llamas that
serves off the paged pool. Standalone under the continuous policy is in
tests/test_torch_family_continuous.py, the vlm and audio families' engine
runs in tests/test_torch_mrope.py (files of their own, so the test workers
share the reference engine's runs).
"""
import sys

import pytest

from _torch_family_cases import NEW_TOKENS, port_run, ref_run


@pytest.mark.parametrize("kind,policy,paged", [("standalone", "serialized", True),
                                               ("standalone", "serialized", False),
                                               ("dpd", "continuous", True)])
def test_moe_tokens_match_reference_engine(kind, policy, paged):
    want, want_clock = ref_run("qwen2-moe-a2.7b", kind, policy)
    got, eng = port_run("qwen2-moe-a2.7b", kind, policy, paged)
    assert got == want
    assert eng.clock == want_clock
    assert eng.paged is paged
    assert all(len(t) == NEW_TOKENS for t in got.values())
    if paged:
        assert eng.pool.gather_calls == 0, "paged decode must be gather-free"


@pytest.mark.parametrize("kind", ["standalone", "dpd"])
def test_launcher_serves_moe_on_the_cpu(kind, monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2-moe-a2.7b", "--kind", kind, "--device", "cpu",
        "--requests", "3", "--max-new", "4", "--qps", "50"])
    serve.main()
    assert "requests: 3  output tokens: 12" in capsys.readouterr().out
