"""The port's data-parallel and elastic training over torch.distributed
(gloo, CPU processes) against the reference's, and its launcher.

- `int8_allreduce_mean` on 4 ranks == the reference's under shard_map on 4
  host devices (--xla_force_host_platform_device_count=4), from the same
  per-shard numpy inputs: the int8 sums are exact, the scale the same fp32.
- `make_compressed_train_step` on 4 ranks against the reference's on 4
  devices: the same weights (the reference's, handed over as a checkpoint
  in the shared format) and the same per-shard batches, two steps.


The reference runs in a subprocess of its own (its host devices must be set
before JAX starts), the port's ranks in subprocesses through
tests/_torch_dist.py, both at once. The elastic trainer and the launcher
are in tests/test_torch_train_elastic.py.
"""
import copy
import os
import re
import sys
import textwrap

import jax
import numpy as np
import torch

from _torch_dist import SRC, Process, start_ranks
from _torch_train_cases import bridged
from repro.training import checkpoint as rckpt
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import tree_leaves

WORLD = 4


def _ref(script: str, tmp, timeout: int = 300) -> Process:
    """The reference's script on WORLD host devices, started."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    return Process([sys.executable, "-c", textwrap.dedent(script), str(tmp)], env, timeout)


_REF_INT8 = """
import sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_host_mesh
from repro.distributed.compression import int8_allreduce_mean
from repro.distributed.sharding import shard_map
x = np.random.default_rng(0).normal(size=(4, 257)).astype(np.float32)
x[2, 5] = 7.5                      # one large element sets the shared scale
mesh = make_host_mesh(data=4, model=1)
f = jax.jit(shard_map(lambda s: int8_allreduce_mean(s[0], "data")[None],
                      mesh=mesh, in_specs=P("data"), out_specs=P("data")))
np.save(sys.argv[1] + "/ref_int8.npy", np.asarray(f(x)))
"""

_PORT_INT8 = """
import sys
import numpy as np, torch, torch.distributed as dist
dist.init_process_group("gloo")
from repro_torch.distributed.compression import int8_allreduce_mean
x = np.random.default_rng(0).normal(size=(4, 257)).astype(np.float32)
x[2, 5] = 7.5
r = dist.get_rank()
got = int8_allreduce_mean(torch.from_numpy(x[r])).numpy()
np.save(sys.argv[1] + f"/port_int8_{r}.npy", got)
dist.destroy_process_group()
"""


def test_int8_allreduce_mean_equals_reference(tmp_path):
    ref, port = _ref(_REF_INT8, tmp_path), start_ranks(_PORT_INT8, WORLD, str(tmp_path),
                                                        timeout=120)
    ref.wait()
    port.wait()
    want = np.load(tmp_path / "ref_int8.npy")
    x = np.random.default_rng(0).normal(size=(4, 257)).astype(np.float32)
    x[2, 5] = 7.5
    for r in range(WORLD):
        got = np.load(tmp_path / f"port_int8_{r}.npy")
        assert np.array_equal(got, want[r]), np.abs(got - want[r]).max()
    assert np.abs(want[0] - x.mean(0)).max() < 7.5 / 127      # within one quantum


_REF_COMPRESSED = """
import sys
import jax, numpy as np
from repro.configs import get_reduced_config
from repro.launch.mesh import make_host_mesh
from repro.models import init_params
from repro.training import checkpoint as ckpt
from repro.training.train_step import make_compressed_train_step, init_residual
from repro.training.optimizer import init_opt_state, AdamWConfig
from repro.training.data import DataPipeline
cfg = get_reduced_config("yi-6b", dtype="float32")
mesh = make_host_mesh(data=4, model=1)
params = init_params(jax.random.PRNGKey(0), cfg)
step = make_compressed_train_step(mesh, cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
res = init_residual(params, mesh)
pipe = DataPipeline(cfg, mesh, batch=8, seq=16, seed=0, dtype=np.float32)
p, o = params, init_opt_state(params)
for _ in range(2):
    p, o, res, m = step(p, o, res, next(pipe))
    print("LOSS", float(m["loss"]), "GNORM", float(m["grad_norm"]))
ckpt.save(sys.argv[1] + "/ref", 2, {"params": p})
"""

_PORT_COMPRESSED = """
import sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo")
from repro_torch.configs import get_reduced_config
from repro_torch.models import backbone
from repro_torch.models.layers import TRAIN_EXEC
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import synthetic_batch, to_device
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import init_residual, make_compressed_train_step
cfg = get_reduced_config("yi-6b", dtype="float32")
like = {"params": backbone.init_params(torch.Generator().manual_seed(1), cfg)}
_, tree = ckpt.restore_latest(sys.argv[1] + "/init", like)   # the reference's weights
p = tree["params"]
step = make_compressed_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1), TRAIN_EXEC)
r, o, res = dist.get_rank(), init_opt_state(p), init_residual(p)
for i in range(2):
    full = synthetic_batch(cfg, 8, 16, 0, i)
    mine = to_device({k: v[2 * r:2 * r + 2] for k, v in full.items()}, "cpu", torch.float32)
    p, o, res, m = step(p, o, res, mine)
    print("LOSS", float(m["loss"]), "GNORM", float(m["grad_norm"]))
ckpt.save(sys.argv[1] + f"/port{r}", 2, {"params": p})
dist.destroy_process_group()
"""

# The compressed step quantizes every gradient to int8 with a shared scale:
# where the two frameworks' fp32 gradients differ by an ulp, round(g /
# scale) can land on the other integer, a quantum (max|g| / 127) away, and
# in Adam's normalised update that can turn an element's step. Limits as the
# sharded step's (tests/test_torch_train_sharding.py): no element off by
# more than 4 lr (two steps of at most ~1 lr each, turned), at most 0.5% off
# by more than 0.1 lr, the L2 norm of the difference within 5% of the two
# steps' movement; the losses within 1e-6 (step 1, the same params) and
# 1e-4 (step 2) relative, the gradient norms (of the synced, quantized
# gradients) within 1e-3.
LR = 1e-3
TOL_MAX_LR, TOL_OFF_SHARE, TOL_REL_L2 = 4.0, 5e-3, 5e-2
TOL_LOSS = (1e-6, 1e-4)


def _numbers(out: str, key: str) -> list[float]:
    return [float(v) for v in re.findall(rf"{key} (\S+)", out)]


def _params(path, cfg, like):
    return tree_leaves(ckpt.restore_latest(str(path), copy.deepcopy(like))[1]["params"])


def test_compressed_step_on_4_ranks_matches_reference(tmp_path):
    rcfg, rparams, cfg, params = bridged("yi-6b")
    rckpt.save(str(tmp_path / "init"), 0, {"params": jax.tree.map(jax.numpy.asarray, rparams)})
    ref = _ref(_REF_COMPRESSED, tmp_path, timeout=240)
    outs = start_ranks(_PORT_COMPRESSED, WORLD, str(tmp_path), timeout=240).wait()
    want = ref.wait()
    for out in outs:
        assert out == outs[0]                  # every rank holds the same state
    assert len(_numbers(outs[0], "LOSS")) == 2
    for got, ref_, tol in zip(_numbers(outs[0], "LOSS"), _numbers(want, "LOSS"), TOL_LOSS):
        assert abs(got - ref_) < tol * ref_, (got, ref_)
    for got, ref_ in zip(_numbers(outs[0], "GNORM"), _numbers(want, "GNORM")):
        assert abs(got - ref_) < 1e-3 * ref_, (got, ref_)
    like = {"params": params}
    mine = [_params(tmp_path / f"port{r}", cfg, like) for r in range(WORLD)]
    assert all(torch.equal(a, b) for m in mine[1:] for a, b in zip(m, mine[0]))
    theirs, p0 = _params(tmp_path / "ref", cfg, like), tree_leaves(params)
    diffs = [(a - b).abs() for a, b in zip(mine[0], theirs)]
    moved = sum(float(((b - c) ** 2).sum()) for b, c in zip(theirs, p0)) ** 0.5
    assert max(float(d.max()) for d in diffs) < TOL_MAX_LR * LR
    off = sum(int((d > 0.1 * LR).sum()) for d in diffs) / sum(d.numel() for d in diffs)
    assert off < TOL_OFF_SHARE, off
    assert sum(float((d ** 2).sum()) for d in diffs) ** 0.5 < TOL_REL_L2 * moved
