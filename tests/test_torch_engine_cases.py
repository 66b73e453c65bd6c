"""Shared workload of the engine parity tests (tests/test_torch_engine.py,
tests/test_torch_spec_engine.py): the fixture of tests/test_paged_engine.py
- 2-layer reduced yi-6b target and llama-300m draft, ragged prompts, 6 new
tokens, greedy - in fp32, run through the reference engine and the port's.
It holds no tests of its own.
"""
import functools

import jax
import numpy as np

from repro.configs import get_reduced_config as ref_config
from repro.models import backbone as rbb
from repro.serving.batching import BatchPolicy as RefPolicy
from repro.serving.engine import ServingEngine as RefEngine
from repro_torch.configs import get_reduced_config
from repro_torch.serving.batching import BatchPolicy
from repro_torch.serving.engine import ServingEngine
from repro_torch.weights import from_reference

CFG = get_reduced_config("yi-6b", num_layers=2, dtype="float32")
DCFG = get_reduced_config("llama-300m", num_layers=2, dtype="float32")
REF_CFG = ref_config("yi-6b", num_layers=2, dtype="float32")
REF_DCFG = ref_config("llama-300m", num_layers=2, dtype="float32")
POLICIES = {"serialized": ("serialized", "serialized"),
            "continuous": (BatchPolicy(kind="continuous", chunk_tokens=16, block_size=8),
                           RefPolicy(kind="continuous", chunk_tokens=16, block_size=8))}
NEW_TOKENS = 6


def prompts():
    rng = np.random.default_rng(3)
    # ragged on purpose: mid-block, multi-block, block-aligned + 1 lengths
    return [list(rng.integers(1, 400, size=n)) for n in (5, 19, 33)]


@functools.lru_cache(maxsize=None)
def ref_params():
    return (rbb.init_params(jax.random.PRNGKey(0), REF_CFG),
            rbb.init_params(jax.random.PRNGKey(1), REF_DCFG))


@functools.lru_cache(maxsize=None)
def port_params():
    target, draft = ref_params()
    return (from_reference(jax.tree.map(np.asarray, target), CFG, device="cpu"),
            from_reference(jax.tree.map(np.asarray, draft), DCFG, device="cpu"))


def _run(engine_cls, cfg, dcfg, params, kind, policy, **extra):
    kw = {}
    if kind in ("spec", "dsd"):
        kw = dict(draft_cfg=dcfg, draft_params=params[1], old_chip="t4")
    if kind == "dpd":
        kw = dict(old_chip="t4")
    kw.update(extra)
    eng = engine_cls(cfg, params[0], kind=kind, temperature=0.0, seed=0, block_size=8,
                     pool_blocks=128, batching=policy, **kw)
    return eng


def _drive(eng):
    for i, p in enumerate(prompts()):
        eng.submit(p, NEW_TOKENS, arrival_s=0.05 * i)
    done = eng.run_until_idle()
    return {r.req_id: list(r.out_tokens) for r in done}


@functools.lru_cache(maxsize=None)
def ref_tokens(kind: str, policy: str):
    """The reference engine's greedy streams (dense path)."""
    eng = _run(RefEngine, REF_CFG, REF_DCFG, ref_params(), kind, POLICIES[policy][1],
               paged=False)
    return _drive(eng), eng.clock


def port_run(kind: str, policy: str, paged, poison: bool = False, **extra):
    """The port's greedy streams on the CPU, and its engine."""
    eng = _run(ServingEngine, CFG, DCFG, port_params(), kind, POLICIES[policy][0],
               paged=paged, device="cpu", **extra)
    if poison:
        # large-but-finite garbage in every pool slot, the dump block too;
        # prefill overwrites owned slots, masks must hide the rest
        for pool in filter(None, [eng.pool, eng.draft_pool]):
            pool.k.fill_(1e4)
            pool.v.fill_(-1e4)
    return _drive(eng), eng
