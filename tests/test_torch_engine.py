"""The port's ServingEngine on the CPU: standalone and dpd.

Greedy token streams must equal the reference engine's on fp32 reduced
configs, under both batching policies and on both the paged and the dense
path; within the port the paged path must be gather-free and a poisoned
pool unobservable. The spec/dsd kinds are in tests/test_torch_spec_engine.py
(a file of their own, so the test workers share the load).
"""
import numpy as np
import pytest
import torch

from test_torch_engine_cases import CFG, POLICIES, port_params, port_run, prompts, ref_tokens
from repro_torch.serving.batching import BatchPolicy
from repro_torch.serving.engine import ServingEngine


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("kind", ["standalone", "dpd"])
def test_tokens_match_reference_engine(kind, policy, paged):
    want, want_clock = ref_tokens(kind, policy)
    got, eng = port_run(kind, policy, paged)
    assert got == want
    assert eng.clock == want_clock          # the shared cost model, same schedule
    assert eng.paged is paged
    if paged:
        assert eng.pool.gather_calls == 0, "paged decode must be gather-free"


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_paged_auto_follows_use_kernels(policy):
    """The port's ExecConfig.use_kernels defaults to True, so paged="auto"
    takes the gather-free path."""
    dense, _ = port_run("standalone", policy, False)
    auto, eng = port_run("standalone", policy, "auto")
    assert eng.paged is True
    assert auto == dense
    assert eng.pool.gather_calls == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pool_garbage_unobservable(paged):
    """Finite poison in every pool slot must not change a token: the
    ragged-length masks, not zeroed storage, exclude unwritten slots."""
    policy = "continuous" if paged else "serialized"
    clean, _ = port_run("standalone", policy, paged)
    dirty, _ = port_run("standalone", policy, paged, poison=True)
    assert clean == dirty


def test_prefix_cache_with_paged_path():
    """Prefix sharing (adopted blocks, refcount > 1) under the paged path:
    same tokens as the dense engine, zero gathers."""
    policy = BatchPolicy(kind="continuous", chunk_tokens=16, block_size=8,
                         prefix_cache=True)
    rng = np.random.default_rng(7)
    shared = list(rng.integers(1, 400, size=16))          # two full shared blocks
    prefixed = [shared + list(rng.integers(1, 400, size=n)) for n in (4, 9, 21)]

    def go(paged):
        eng = ServingEngine(CFG, port_params()[0], kind="standalone", temperature=0.0,
                            seed=0, block_size=8, pool_blocks=128, batching=policy,
                            paged=paged, device="cpu")
        for i, p in enumerate(prefixed):
            eng.submit(p, 6, arrival_s=0.2 * i)
        return {r.req_id: list(r.out_tokens) for r in eng.run_until_idle()}, eng

    dense, _ = go(False)
    paged, eng = go(True)
    assert dense == paged
    assert eng.pool.gather_calls == 0


def test_engine_sim_parity():
    """The port's engine charges what the port's simulator charges."""
    from repro_torch.serving.simulator import ServingMode, simulate
    from repro_torch.serving.workload import Request

    pl, out, n, pool_blocks = 12, 6, 3, 512
    eng = ServingEngine(CFG, port_params()[0], kind="standalone", temperature=0.0,
                        seed=1, max_batch=8, pool_blocks=pool_blocks,
                        batching="continuous", device="cpu")
    assert eng.paged is True
    for i in range(n):
        eng.submit((np.arange(pl) + i) % CFG.vocab_size, max_new_tokens=out, arrival_s=0.0)
    eng.run_until_idle()
    assert eng.pool.gather_calls == 0
    reqs = [Request(i, 0.0, pl, out) for i in range(n)]
    mode = ServingMode("standalone", "standalone", "a100", None, max_batch=8)
    res = simulate(mode, CFG, reqs, seed=1, batching=BatchPolicy(num_blocks=pool_blocks))
    assert eng.clock == pytest.approx(res.duration_s, rel=0.02)
    for name in res.use:
        assert eng.use[name].energy_j == pytest.approx(res.use[name].energy_j, rel=0.05)


def test_engine_defaults_to_the_card(monkeypatch):
    """Without a device the engine runs on the card; with no card it raises
    instead of carrying on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(CFG, port_params()[0])


def test_engine_refuses_params_on_another_device():
    with pytest.raises(ValueError, match="live on"):
        ServingEngine(CFG, port_params()[0], device="meta")


def test_requests_finish_with_their_token_counts():
    got, eng = port_run("standalone", "continuous", True)
    assert sorted(got) == list(range(len(prompts())))
    assert all(len(t) == 6 for t in got.values())
    assert eng.status_counts()["ok"] == len(prompts())
