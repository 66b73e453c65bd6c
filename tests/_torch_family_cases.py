"""Shared fixtures of the family parity tests (tests/test_torch_moe.py,
test_torch_mrope.py, test_torch_family_engine.py,
test_torch_family_continuous.py):
reduced configs of both packages with the reference's weights bridged into
the port, and the two engines driven over one ragged workload (prompts of 5,
19 and 33 tokens, 6 new tokens each, greedy). It holds no tests of its own.
"""
import functools

import jax
import numpy as np
import torch

from repro.configs import get_reduced_config as ref_config
from repro.models import backbone as rbb
from repro.serving.batching import BatchPolicy as RefPolicy
from repro.serving.engine import ServingEngine as RefEngine
from repro_torch.configs import get_reduced_config
from repro_torch.serving.batching import BatchPolicy
from repro_torch.serving.engine import ServingEngine
from repro_torch.weights import from_reference

# max|a - b| / max|b|. fp32: the two frameworks differ in summation order
# only; bf16: they round the activations at different places (as
# tests/test_torch_model.py)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
NEW_TOKENS = 6
POLICIES = {"serialized": ("serialized", "serialized"),
            "continuous": (BatchPolicy(kind="continuous", chunk_tokens=16, block_size=8),
                           RefPolicy(kind="continuous", chunk_tokens=16, block_size=8))}


def rel_err(a, b) -> float:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6))


def assert_cache_close(got, want, tol=TOL["float32"]) -> None:
    """A K/V cache of the port against the reference's: k and v within
    `tol`, positions equal."""
    assert rel_err(got["k"], want["k"]) < tol
    assert rel_err(got["v"], want["v"]) < tol
    assert got["pos"].tolist() == np.asarray(want["pos"]).tolist()


@functools.lru_cache(maxsize=None)
def bridged(arch: str, dtype: str = "float32", num_layers: int = 2):
    """(reference config, reference params, port config, port params on the
    CPU): the reference's seeded weights carried into the port."""
    rcfg = ref_config(arch, num_layers=num_layers, dtype=dtype)
    cfg = get_reduced_config(arch, num_layers=num_layers, dtype=dtype)
    rparams = rbb.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, cfg, from_reference(jax.tree.map(np.asarray, rparams), cfg,
                                              device="cpu")


def prompts():
    rng = np.random.default_rng(3)
    return [list(rng.integers(1, 400, size=n)) for n in (5, 19, 33)]


def _drive(eng):
    for i, p in enumerate(prompts()):
        eng.submit(p, NEW_TOKENS, arrival_s=0.05 * i)
    done = eng.run_until_idle()
    return {r.req_id: list(r.out_tokens) for r in done}


def _kw(kind):
    return {"old_chip": "t4"} if kind == "dpd" else {}


@functools.lru_cache(maxsize=None)
def ref_run(arch: str, kind: str, policy: str):
    """The reference engine's greedy streams and modelled clock (its dense
    path)."""
    rcfg, rparams, _, _ = bridged(arch)
    eng = RefEngine(rcfg, rparams, kind=kind, temperature=0.0, seed=0, block_size=8,
                    pool_blocks=128, batching=POLICIES[policy][1], paged=False, **_kw(kind))
    return _drive(eng), eng.clock


def port_run(arch: str, kind: str, policy: str, paged):
    """The port's greedy streams on the CPU, and its engine."""
    _, _, cfg, params = bridged(arch)
    eng = ServingEngine(cfg, params, kind=kind, temperature=0.0, seed=0, block_size=8,
                        pool_blocks=128, batching=POLICIES[policy][0], paged=paged,
                        device="cpu", **_kw(kind))
    return _drive(eng), eng
