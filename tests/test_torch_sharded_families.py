"""The sharded train step on a (data 2, model 2) gloo mesh == the unsharded
train_step, for the families and options whose distributed code the dense
case of tests/test_torch_train_sharding.py does not reach:

- rwkv6-7b and zamba2-2.7b (reduced): the chunked WKV and SSD run on each
  rank's batch and head shards (distributed/tensor_parallel.py
  `per_head_region`), gradients through them;
- microbatches=2: each rank slices its own batch shard (train_step
  `_chunks`), so microbatch i holds every rank's i-th slice and the
  microbatches still cover the batch once;
- yi-6b with one kv head, which does not split over "model": its k/v
  projections are gathered whole (`whole_heads`) and attention splits the
  sequences over "model" instead (`local_attention`).

4 CPU processes over gloo (tests/_torch_dist.py), fp32, the same weights
and batches on both sides. The gradients of the first batch are held leaf
by leaf to the plain ones (TOL_GRAD, the training parity tests' fp32
limit: the two sum in other orders); then two AdamW steps, with the dense
test's limits and for the same reasons (tests/test_torch_train_sharding.py).
"""
import pytest

from _torch_dist import run_ranks
from _torch_train_cases import TOL_GRAD
from test_torch_train_sharding import TOL_MAX_LR, TOL_OFF_SHARE, TOL_REL_L2

_STEP = """
import copy, dataclasses, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo")
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import backbone
from repro_torch.models.layers import TRAIN_EXEC
from repro_torch.training import train_step as ts
from repro_torch.training.data import DataPipeline
from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_leaves
TOL_LOSS = (1e-6, 1e-4)           # as tests/test_torch_train_sharding.py
arch, mb, kv = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = get_reduced_config(arch, dtype="float32")
if kv:
    cfg = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, num_kv_heads=kv))
params = backbone.init_params(torch.Generator().manual_seed(0), cfg)
p0 = copy.deepcopy(params)
mesh = make_host_mesh(2, 2)
opt = AdamWConfig(lr=1e-3, warmup_steps=1)
ref_p = copy.deepcopy(params)
ref_o = init_opt_state(ref_p)
sp = ts.shard_params(params, mesh)
so = ts.shard_opt_state(init_opt_state(params), params, mesh)
step = ts.make_sharded_train_step(mesh, cfg, opt, TRAIN_EXEC, microbatches=mb)
plain = DataPipeline(cfg, batch=4, seq=16, device="cpu", dtype=torch.float32)
placed = DataPipeline(cfg, mesh, batch=4, seq=16, dtype=torch.float32)
# the gradients of one step (microbatched as the step is) against the plain
# ones, leaf by leaf; Adam's update hides a gradient off by a factor
with implicit_replication():
    _, gg = ts.loss_and_grads(sp, next(placed), cfg, TRAIN_EXEC, mb)
placed.seek(0)
_, wg = ts.loss_and_grads(ref_p, next(plain), cfg, TRAIN_EXEC, mb)
plain.seek(0)
print("GRAD", max(float((g.full_tensor() - w).abs().max() / w.abs().max())
                  for w, g in zip(tree_leaves(wg), tree_leaves(gg))), flush=True)
for tol in TOL_LOSS:
    ref_p, ref_o, rm = ts.train_step(ref_p, ref_o, next(plain), cfg, opt, TRAIN_EXEC,
                                     microbatches=mb)
    sp, so, m = step(sp, so, next(placed))
    assert abs(float(m["loss"]) - float(rm["loss"])) < tol * float(rm["loss"]), (m, rm)
diffs = [(a - b.full_tensor()).abs() for a, b in zip(tree_leaves(ref_p), tree_leaves(sp))]
moved = sum(float(((a - c) ** 2).sum()) for a, c in zip(tree_leaves(ref_p), tree_leaves(p0))) ** 0.5
print("MAX_LR", max(float(d.max()) for d in diffs) / opt.lr,
      "OFF_SHARE", sum(int((d > 0.1 * opt.lr).sum()) for d in diffs) / sum(d.numel() for d in diffs),
      "REL_L2", sum(float((d ** 2).sum()) for d in diffs) ** 0.5 / moved, flush=True)
dist.destroy_process_group()
"""

# (arch, microbatches, kv heads override; 0 keeps the reduced config's)
CASES = [("rwkv6-7b", 2, 0), ("zamba2-2.7b", 2, 0), ("yi-6b", 2, 0), ("yi-6b", 1, 1)]


@pytest.mark.parametrize("arch,mb,kv", CASES, ids=["rwkv6-mb2", "zamba2-mb2", "yi6b-mb2",
                                                   "yi6b-kv1"])
def test_sharded_step_on_2x2_equals_the_unsharded_step(arch, mb, kv):
    for out in run_ranks(_STEP, 4, arch, str(mb), str(kv), timeout=240):
        f = out.split()
        got = {k: float(f[f.index(k) + 1]) for k in ("GRAD", "MAX_LR", "OFF_SHARE", "REL_L2")}
        assert got["GRAD"] < TOL_GRAD, got
        assert got["MAX_LR"] < TOL_MAX_LR, got
        assert got["OFF_SHARE"] < TOL_OFF_SHARE, got
        assert got["REL_L2"] < TOL_REL_L2, got
