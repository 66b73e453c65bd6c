"""Shared helpers of the training parity tests (tests/test_torch_train_*.py):
the reference's seeded weights and synthetic batches carried into the port,
and value-and-gradient on both sides. It holds no tests of its own."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced_config as ref_config
from repro.models import backbone as rbb
from repro.models.layers import DEFAULT_EXEC
from repro.training.data import synthetic_batch as ref_batch
from repro_torch.configs import get_reduced_config
from repro_torch.training.train_step import value_and_grad
from repro_torch.weights import from_reference, to_reference

FAMILIES = {"dense": "yi-6b", "moe": "qwen2-moe-a2.7b", "ssm": "rwkv6-7b",
            "hybrid": "zamba2-2.7b", "audio": "musicgen-medium", "vlm": "qwen2-vl-72b"}
# loss: |port - ref| / |ref|; a gradient leaf: max|port - ref| / max|ref| of
# that leaf. fp32 on both sides: the frameworks differ in summation order
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def bridged(arch: str, dtype: str = "float32", **overrides):
    """(reference config, reference params as numpy, port config, port
    params on the CPU) from the reference's PRNGKey(0) init."""
    rcfg = ref_config(arch, dtype=dtype, **overrides)
    cfg = get_reduced_config(arch, dtype=dtype, **overrides)
    rparams = np_tree(rbb.init_params(jax.random.PRNGKey(0), rcfg))
    return rcfg, rparams, cfg, from_reference(rparams, cfg, device="cpu")


def batches(rcfg, batch: int = 2, seq: int = 24, step: int = 0):
    """The reference's synthetic batch as (jnp dict, torch dict)."""
    host = ref_batch(rcfg, batch, seq, 0, step)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


@functools.lru_cache(maxsize=None)
def _ref_vg(rcfg, exec_cfg):
    """The reference's value_and_grad of loss_fn, jitted once a config."""
    return jax.jit(lambda p, b: jax.value_and_grad(rbb.loss_fn)(p, b, rcfg, exec_cfg))


def ref_value_and_grad(rparams, jbatch, rcfg, exec_cfg=DEFAULT_EXEC):
    loss, grads = _ref_vg(rcfg, exec_cfg)(jax.tree.map(jnp.asarray, rparams), jbatch)
    return float(loss), np_tree(grads)


def port_value_and_grad(params, tbatch, cfg, exec_cfg):
    loss, grads = value_and_grad(params, tbatch, cfg, exec_cfg)
    return float(loss), to_reference(grads, cfg)


def leaf_errors(got: dict, want: dict) -> dict:
    """{path: max|got - want| / max|want|} over every leaf of `want`."""
    out = {}
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        w = np.asarray(w, np.float32)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(np.asarray(g, np.float32) - w).max() / (np.abs(w).max() + 1e-30))
    return out


__all__ = ["FAMILIES", "TOL_LOSS", "TOL_GRAD", "bridged", "batches", "ref_value_and_grad",
           "port_value_and_grad", "leaf_errors", "np_tree", "to_reference"]
