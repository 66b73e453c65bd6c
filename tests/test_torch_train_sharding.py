"""The port's sharding rules == the reference's, and the sharded train step
on a (data 2, model 2) gloo mesh == the unsharded one.

The rules are pure functions over shapes and a mesh's axis names and sizes,
so they are compared on abstract meshes, no processes: (16, 16) and
(2, 16, 16) (the production meshes) and (2, 2), (4, 1), (1, 1), for the
params of every registry config at full size (the port's on the meta
device, layers a list; each layer's spec is the reference's stacked one),
decode caches and training batches. The sharded step runs in 4 CPU
processes over gloo (a subprocess, as tests/test_distributed.py keeps its
multi-device runs out of the pytest process) and is held to the port's
unsharded train_step on the same weights and batches, and the attention on
heads sharded over "model" (each rank over its own) against the plain one,
gradients included; the reference's own sharded step fails on jax 0.9
(tests/test_distributed.py), so it is not the yardstick here.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_dist import run_ranks
from repro import configs as rconfigs
from repro.distributed import sharding as rsh
from repro.models import backbone as rbb
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import backbone

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((4, 1), ("data", "model")), ((1, 1), ("data", "model"))]
ARCHS = list(rconfigs._ARCH_MODULES)


def _ref_shapes(arch):
    cfg = rconfigs.get_config(arch)
    return cfg, jax.eval_shape(lambda: rbb.init_params(jax.random.PRNGKey(0), cfg))


def _port_like(rshapes, num_layers):
    """The reference's abstract params as the port's tree of meta tensors."""
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), rshapes)
    return {**meta, "layers": [jax.tree.map(lambda a, l=l: a[l], meta["layers"])
                               for l in range(num_layers)]}


def _same(got: tuple, want) -> bool:
    """A port spec against a reference PartitionSpec, by the reference's own
    equality (it reads a one-axis tuple ("data",) as "data")."""
    return isinstance(got, tuple) and P(*got) == want


def _same_dict(got: dict, want: dict) -> bool:
    return sorted(got) == sorted(want) and all(_same(got[k], want[k]) for k in want)


def _assert_same(port, ref, where):
    """A port spec tree (layers a list) against the reference's."""
    for path, want in jax.tree_util.tree_flatten_with_path(
            ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        got = port
        for k in path:
            got = got[k.key]
            if isinstance(got, list):      # every layer answers the stacked spec
                assert all(g == got[0] for g in got)
                got = got[0]
        assert _same(got, want), (where, jax.tree_util.keystr(path), got, want)


@pytest.mark.parametrize("shape,names", MESHES, ids=lambda m: "x".join(map(str, m))
                         if isinstance(m[0], int) else None)
def test_param_and_zero_specs_equal_reference(shape, names):
    rmesh, mesh = rsh.make_abstract_mesh(shape, names), AbstractMesh(shape, names)
    for arch in ARCHS:
        cfg, rshapes = _ref_shapes(arch)
        like = _port_like(rshapes, cfg.num_layers)
        _assert_same(sharding.param_pspecs(like, mesh), rsh.param_pspecs(rshapes, rmesh), arch)
        _assert_same(sharding.zero_pspecs(like, mesh), rsh.zero_pspecs(rshapes, rmesh), arch)


@pytest.mark.parametrize("shape,names", MESHES[:3], ids=["16x16", "2x16x16", "2x2"])
def test_cache_batch_and_token_specs_equal_reference(shape, names):
    rmesh, mesh = rsh.make_abstract_mesh(shape, names), AbstractMesh(shape, names)
    for arch in ARCHS:
        rcfg, cfg = rconfigs.get_config(arch), configs.get_config(arch)
        for b, s in ((128, 32768), (1, 524288), (3, 64)):
            rc = jax.eval_shape(lambda: rbb.init_cache(rcfg, b, s))
            c = backbone.init_cache(cfg, b, s, device="meta")
            want = rsh.cache_pspecs(rc, rcfg, rmesh)
            assert _same_dict(sharding.cache_pspecs(c, cfg, mesh), want), (arch, b, s)
        for b in (256, 3):
            batch = {"tokens": torch.empty(b, 16, device="meta"),
                     "labels": torch.empty(b, 16, device="meta")}
            if rcfg.attn is not None and rcfg.attn.m_rope_sections is not None:
                batch["positions"] = torch.empty(3, b, 16, device="meta")
            want = rsh.batch_pspecs(jax.tree.map(lambda t: jax.ShapeDtypeStruct(
                t.shape, jax.numpy.int32), batch), rmesh)
            assert _same_dict(sharding.batch_pspecs(batch, mesh), want), (arch, b)
    for shp in ((256, 4096), (1,), (3, 5)):
        assert _same(sharding.tokens_pspec(shp, mesh), rsh.tokens_pspec(shp, rmesh))
    for e in (16, 60, 128, 1):
        assert sharding.ep_axes_for(mesh, e) == rsh.ep_axes_for(rmesh, e)


def test_zero_variant_rules_and_production_meshes():
    rmesh = rsh.make_abstract_mesh((16, 16), ("data", "model"))
    mesh = make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    for spec, shp in (((None, "model"), (4096, 11008)), ((None, None, "model"), (7, 4096, 512)),
                      ((None, "data", None, "model"), (48, 16, 5120, 8192)),
                      ((None,), (3,))):
        assert _same(sharding.zero_variant(spec, shp, mesh),
                     rsh.zero_variant(P(*spec), shp, rmesh))
    assert sharding.zero_variant((None, "model"), (4096, 11008), mesh) == (("data",), "model")


def test_placements_drop_the_layer_axis():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2), ("data", "model"))
    # a stacked spec read for one layer: the L entry dropped
    assert sharding.placements((None, None, "model"), (128, 256), mesh) == [Replicate(), Shard(1)]
    # ZeRO over the layers moves to the layer's first free divisible dim
    assert sharding.placements((("data",), None, "model"), (128, 256), mesh) == \
        [Shard(0), Shard(1)]
    assert sharding.placements(("model", None), (512, 128), mesh) == [Replicate(), Shard(0)]
    assert sharding.placements((), (), mesh) == [Replicate(), Replicate()]


_SHARDED = """
import sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo")
import copy
from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import backbone
from repro_torch.models.layers import TRAIN_EXEC
from repro_torch.training import train_step as ts
from repro_torch.training.data import DataPipeline
from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_leaves
# relative loss: step 1 from the same params; step 2 after an update at lr
# 1e-3 whose bf16 gradients round the other way here and there (the two
# sum in another order), which moves the loss by about 1e-5
TOL_LOSS = (1e-6, 1e-4)
cfg = get_reduced_config(sys.argv[1], dtype="float32")
params = backbone.init_params(torch.Generator().manual_seed(0), cfg)
mesh = make_host_mesh(2, 2)
opt = AdamWConfig(lr=1e-3, warmup_steps=1)
ref_p = copy.deepcopy(params)
ref_o = init_opt_state(ref_p)
sp = ts.shard_params(params, mesh)
so = ts.shard_opt_state(init_opt_state(params), params, mesh)
step = ts.make_sharded_train_step(mesh, cfg, opt, TRAIN_EXEC)
plain = DataPipeline(cfg, batch=4, seq=16, device="cpu", dtype=torch.float32)
placed = DataPipeline(cfg, mesh, batch=4, seq=16, dtype=torch.float32)
for tol in TOL_LOSS:
    ref_p, ref_o, rm = ts.train_step(ref_p, ref_o, next(plain), cfg, opt, TRAIN_EXEC)
    sp, so, m = step(sp, so, next(placed))
    assert abs(float(m["loss"]) - float(rm["loss"])) < tol * float(rm["loss"]), (m, rm)
# the placements held: TP on "model", ZeRO on "data"
wq = sp["layers"][0]["attn"]["wq"]
assert [str(p) for p in wq.placements] == ["R", "S(1)"], wq.placements
mq = so["m"]["layers"][0]["attn"]["wq"]
assert [str(p) for p in mq.placements] == ["S(0)", "S(1)"], mq.placements
assert [str(p) for p in sp["tok"]["embed"].placements] == ["R", "S(0)"]
# attention with the kv heads sharded over "model" too (as at full width,
# where the kv projections shard): each rank attends over its own heads
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.models.attention import blocked_attention
g = torch.Generator().manual_seed(3)
q, k, v = (torch.randn(4, 16, h, 8, generator=g) for h in (4, 2, 2))
for t in (q, k, v):
    t.requires_grad_()
want = blocked_attention(q, k, v, True, 8)
want.square().sum().backward()
dq, dk, dv = (distribute_tensor(t.detach(), mesh, [Shard(0), Shard(2)], src_data_rank=None)
              .requires_grad_() for t in (q, k, v))
got = blocked_attention(dq, dk, dv, True, 8)
assert [str(p) for p in got.placements] == ["S(0)", "S(2)"], got.placements
got.full_tensor().square().sum().backward()
for a, b in ((got, want), (dq.grad, q.grad), (dk.grad, k.grad), (dv.grad, v.grad)):
    assert (a.full_tensor() - b).abs().max() <= 1e-6 * b.abs().max(), (a.full_tensor() - b).abs().max()
p0 = tree_leaves(backbone.init_params(torch.Generator().manual_seed(0), cfg))
diffs = [(a - b.full_tensor()).abs() for a, b in zip(tree_leaves(ref_p), tree_leaves(sp))]
moved = sum(float(((a - c) ** 2).sum()) for a, c in zip(tree_leaves(ref_p), p0)) ** 0.5
print("MAX_LR", max(float(d.max()) for d in diffs) / opt.lr,
      "OFF_SHARE", sum(int((d > 0.1 * opt.lr).sum()) for d in diffs) / sum(d.numel() for d in diffs),
      "REL_L2", sum(float((d ** 2).sum()) for d in diffs) ** 0.5 / moved, flush=True)
dist.destroy_process_group()
"""

# the sharded step against the unsharded one after two steps at lr 1e-3.
# The two sum the products and the batch in other orders, so their bf16
# gradients round the other way at about 0.1% of the elements (as the port
# against the reference, tests/test_torch_train_step.py); where a gradient
# sits near zero, or the two steps' nearly cancel in Adam's first moment,
# such a flip turns that element's update. An update is at most ~1 lr a
# step (|m^ / sqrt(v^)| <= 1 at b1 0.9, b2 0.95), so two steps differ by
# 4 lr at most. So: no element off by more than 4 lr, at most 0.5% off by
# more than 0.1 lr, and the difference's L2 norm within 5% of the two
# steps' movement.
TOL_MAX_LR, TOL_OFF_SHARE, TOL_REL_L2 = 4.0, 5e-3, 5e-2


def test_sharded_step_on_2x2_equals_the_unsharded_step():
    for out in run_ranks(_SHARDED, 4, "yi-6b", timeout=240):
        f = out.split()
        got = {k: float(f[f.index(k) + 1]) for k in ("MAX_LR", "OFF_SHARE", "REL_L2")}
        assert got["MAX_LR"] < TOL_MAX_LR, got
        assert got["OFF_SHARE"] < TOL_OFF_SHARE, got
        assert got["REL_L2"] < TOL_REL_L2, got
