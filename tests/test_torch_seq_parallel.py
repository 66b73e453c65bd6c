"""The sequence-parallel residual stream (ExecConfig.carry_spec) and the
expert-parallel MoE dispatch (ExecConfig.ep_axes) on a (data 2, model 2)
gloo mesh, 4 CPU processes (tests/_torch_dist.py), fp32, reduced configs.

(a) The sharded step with carry_spec=(("data",), "model", None) (and
    ep_axes=("data",) for qwen2-moe, its 4 experts over the 2 data ranks,
    in groups of 2 tokens: 32 groups, so the groups stay on the data axes
    and the dispatch goes through the all-to-all) against the unsharded
    step on the same weights and batches: the first batch's gradients leaf
    by leaf (TOL_GRAD), then two AdamW steps at the limits of
    tests/test_torch_train_sharding.py. Every layer's output is the carry:
    the batch on "data", the sequence on "model". The sharded prefill under
    the same ExecConfig gives the plain prefill's last-token logits. The
    same for qwen2-moe on a (pod 2, data 2, model 1) mesh, its experts
    over "pod" alone or over both data axes (an exchange a mesh dim).
(b) The expert-parallel `moe_ffn` (tensor_parallel.expert_parallel_region)
    against the live reference's `moe_ffn` on the same numpy weights and
    input: the test process runs the reference without a mesh (its anchors
    are no-ops) and hands the arrays to the ranks. Two layouts: groups of 8
    tokens (32 groups on the data axes, exchanged by all-to-all) and one
    group of every token (replicated, split by capacity slots before the
    exchange). Capacity factor 0.5, so units drop. The kept units are the
    same: with each expert's down projection cut to its own block of
    output columns, a token's output is nonzero in expert e's block exactly
    where its unit for e was kept, on both sides. The gradients (input and
    every weight) equal the whole-tensor port's.
(c) `moe_aux_loss` through `batch_sum_region` equals the whole-tensor value,
    its gradients too.
(d) carry_spec=None leaves the existing sharded step as it was: no layer
    output is sequence-sharded, the MoE runs whole (`replicated_region`,
    no all-to-all), and its gradients equal the plain ones.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_train_cases import TOL_GRAD
from repro.models import layers as rlayers
from repro_torch.configs import get_reduced_config
from test_torch_train_sharding import TOL_MAX_LR, TOL_OFF_SHARE, TOL_REL_L2

ARCH_MOE = "qwen2-moe-a2.7b"

_STEP = """
import copy, dataclasses, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo")
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import backbone
from repro_torch.models.layers import TRAIN_EXEC
from repro_torch.training import train_step as ts
from repro_torch.training.data import DataPipeline
from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_leaves
import repro_torch.models.layers as L
TOL_LOSS = (1e-6, 1e-4)           # as tests/test_torch_train_sharding.py
# what the step does: each stage's output placement, the MoE region taken
seen = {}
stages = backbone._train_stages
def recorded(*a):
    def wrap(f):
        def run(x):
            y = f(x)
            if isinstance(y, DTensor):
                seen["stage"].add(",".join(str(q) for q in y.placements))
            return y
        return run
    return [wrap(f) for f in stages(*a)]
backbone._train_stages = recorded
a2a, rep = tp._all_to_all, tp.replicated_region
def counted_a2a(*a):
    seen["a2a"] += 1
    return a2a(*a)
def counted_rep(*a):
    seen["replicated"] += 1
    return rep(*a)
tp._all_to_all = counted_a2a
L.replicated_region = counted_rep
# (data, model), or (pod, data, model) with the data axes split in two
meshes = {2: init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")),
          3: init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))}
opt = AdamWConfig(lr=1e-3, warmup_steps=1)
rel = lambda a, b: float((a - b).abs().max() / b.abs().max())

def run(arch, carry, ep, group, ndim):
    seen.update(stage=set(), a2a=0, replicated=0)
    mesh = meshes[ndim]
    cfg = get_reduced_config(arch, dtype="float32")
    dp = mesh.mesh_dim_names[:-1]
    ex = dataclasses.replace(TRAIN_EXEC, moe_group_size=group,
                             carry_spec=(dp, "model", None) if carry else None,
                             ep_axes=tuple(ep.split("+")) if ep else None)
    params = backbone.init_params(torch.Generator().manual_seed(0), cfg)
    p0 = copy.deepcopy(params)
    ref_p = copy.deepcopy(params)
    ref_o = init_opt_state(ref_p)
    sp = ts.shard_params(params, mesh)
    so = ts.shard_opt_state(init_opt_state(params), params, mesh)
    step = ts.make_sharded_train_step(mesh, cfg, opt, ex)
    plain = DataPipeline(cfg, batch=4, seq=16, device="cpu", dtype=torch.float32)
    placed = DataPipeline(cfg, mesh, batch=4, seq=16, dtype=torch.float32)
    with implicit_replication():
        _, gg = ts.loss_and_grads(sp, next(placed), cfg, ex)
    placed.seek(0)
    _, wg = ts.loss_and_grads(ref_p, next(plain), cfg, ex)
    plain.seek(0)
    out = {"GRAD": max(rel(g.full_tensor(), w) for w, g in zip(tree_leaves(wg), tree_leaves(gg))),
           "STAGES": "|".join(sorted(seen["stage"])), "A2A": seen["a2a"],
           "REPLICATED": seen["replicated"]}
    if not carry:
        return out
    # the sharded prefill under the same ExecConfig: last-token logits
    tokens, placed_tokens = next(plain)["tokens"], next(placed)["tokens"]
    plain.seek(0)
    placed.seek(0)
    with implicit_replication(), torch.no_grad():
        got, _ = backbone.prefill(sp, {"tokens": placed_tokens}, cfg, ex)
        want, _ = backbone.prefill(ref_p, {"tokens": tokens}, cfg, ex)
    out["PREFILL"] = rel(got.full_tensor(), want)
    for tol in TOL_LOSS:
        ref_p, ref_o, rm = ts.train_step(ref_p, ref_o, next(plain), cfg, opt, ex)
        sp, so, m = step(sp, so, next(placed))
        assert abs(float(m["loss"]) - float(rm["loss"])) < tol * float(rm["loss"]), (m, rm)
    diffs = [(a - b.full_tensor()).abs() for a, b in zip(tree_leaves(ref_p), tree_leaves(sp))]
    moved = sum(float(((a - c) ** 2).sum())
                for a, c in zip(tree_leaves(ref_p), tree_leaves(p0))) ** 0.5
    out.update(MAX_LR=max(float(d.max()) for d in diffs) / opt.lr,
               OFF_SHARE=sum(int((d > 0.1 * opt.lr).sum()) for d in diffs)
               / sum(d.numel() for d in diffs),
               REL_L2=sum(float((d ** 2).sum()) for d in diffs) ** 0.5 / moved)
    return out

for case in sys.argv[1:]:
    name, spec = case.split("=")
    arch, carry, ep, group, ndim = spec.split(",")
    fields = run(arch, carry == "1", ep, int(group), int(ndim))
    print(name, " ".join(f"{k} {v}" for k, v in fields.items()), flush=True)
dist.destroy_process_group()
"""

CARRY = "S(0),S(1)"      # a layer output placed as the carry on (data, model)


def _by_case(outs: list[str]) -> dict:
    """{case: [its fields on each rank]} from every rank's lines `case key
    value key value ...`."""
    cases: dict = {}
    for out in outs:
        for line in out.splitlines():
            name, *f = line.split()
            cases.setdefault(name, []).append(dict(zip(f[::2], f[1::2])))
    return cases


# case: (arch, carry, ep_axes joined by "+", moe_group_size, mesh dims); all
# run in one set of ranks
STEP_CASES = {"dense": ("yi-6b", True, "", 4096, 2), "ssm": ("rwkv6-7b", True, "", 4096, 2),
              "hybrid": ("zamba2-2.7b", True, "", 4096, 2),
              "moe-ep": (ARCH_MOE, True, "data", 2, 2),
              "no-carry": (ARCH_MOE, False, "", 2, 2),
              "moe-ep-pod": (ARCH_MOE, True, "pod", 2, 3),
              "moe-ep-pod-data": (ARCH_MOE, True, "pod+data", 2, 3)}


@pytest.fixture(scope="module")
def step_runs():
    args = [f"{n}={a},{int(c)},{e},{g},{m}" for n, (a, c, e, g, m) in STEP_CASES.items()]
    return _by_case(run_ranks(_STEP, 4, *args, timeout=600))


@pytest.mark.parametrize("case", ["dense", "ssm", "hybrid", "moe-ep"])
def test_seq_parallel_step_on_2x2_equals_the_unsharded_step(step_runs, case):
    ep = STEP_CASES[case][2]
    for got in step_runs[case]:
        assert float(got["GRAD"]) < TOL_GRAD, got
        assert got["STAGES"] == CARRY, got
        # 2 layers x (forward, its recompute, backward) x (to the experts, back)
        assert int(got["A2A"]) == (12 if ep else 0), got
        assert float(got["PREFILL"]) < 1e-5, got        # fp32, summation order only
        assert float(got["MAX_LR"]) < TOL_MAX_LR, got
        assert float(got["OFF_SHARE"]) < TOL_OFF_SHARE, got
        assert float(got["REL_L2"]) < TOL_REL_L2, got


@pytest.mark.parametrize("case", ["moe-ep-pod", "moe-ep-pod-data"])
def test_expert_parallel_over_part_or_all_of_two_data_axes(step_runs, case):
    """A (pod 2, data 2, model 1) mesh: the groups on both data axes, the
    experts over "pod" alone (the banks' gradients partial over "data") or
    over both (one exchange a mesh dim)."""
    dims = len(STEP_CASES[case][2].split("+"))
    for got in step_runs[case]:
        assert float(got["GRAD"]) < TOL_GRAD, got
        assert got["STAGES"] == "S(0),S(0),S(1)", got
        assert int(got["A2A"]) == 12 * dims, got
        assert float(got["PREFILL"]) < 1e-5, got
        assert float(got["MAX_LR"]) < TOL_MAX_LR, got
        assert float(got["OFF_SHARE"]) < TOL_OFF_SHARE, got
        assert float(got["REL_L2"]) < TOL_REL_L2, got


def test_no_carry_leaves_the_sharded_step_as_it_was(step_runs):
    for got in step_runs["no-carry"]:
        assert float(got["GRAD"]) < TOL_GRAD, got
        assert "S(1)" not in got["STAGES"], got
        assert int(got["A2A"]) == 0, got
        # moe_ffn a layer (forward, its recompute) and moe_aux_loss, whole
        assert int(got["REPLICATED"]) == 5, got


# ------------------------------------------------------- the MoE region alone
_MOE = """
import dataclasses, sys
import numpy as np
import torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo")
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers
from repro_torch.models.layers import ExecConfig
mesh = make_host_mesh(2, 2)
names = ("router", "w_gate", "w_up", "w_down")
rel = lambda a, b: float((a - b).abs().max() / b.abs().max())

def case(path, group, cf):
    data = np.load(path)
    cfg = get_reduced_config("qwen2-moe-a2.7b", dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    carry = ExecConfig(moe_group_size=group, carry_spec=(("data",), "model", None),
                       ep_axes=sharding.ep_axes_for(mesh, cfg.moe.num_experts))
    plain = ExecConfig(moe_group_size=group)
    assert carry.ep_axes == ("data",), carry.ep_axes
    def weights(prefix):
        p = {k: torch.from_numpy(data[prefix + k]) for k in names}
        p["shared"] = {k: torch.from_numpy(data[prefix + "shared_" + k]) for k in names[1:]}
        return p
    def placed_weights(p):
        specs = sharding.param_pspecs({"layers": [{"moe": p}]}, mesh)["layers"][0]["moe"]
        return {k: placed_weights_of(p[k], specs[k]) for k in p}
    def placed_weights_of(t, s):
        if isinstance(t, dict):
            return {k: placed_weights_of(t[k], s[k]) for k in t}
        return sharding.distribute(t, mesh, s).requires_grad_()
    def leaves(p):
        return [v for k in sorted(p) for v in (leaves(p[k]) if isinstance(p[k], dict) else [p[k]])]
    x = torch.from_numpy(data["x"])
    ct = torch.from_numpy(data["ct"])
    def region(p):
        dp = placed_weights(p)
        dx = distribute_tensor(x, mesh, [Shard(0), Replicate()], src_data_rank=None).requires_grad_()
        with implicit_replication():
            out = layers.moe_ffn(dp, dx, cfg, carry)
            aux = layers.moe_aux_loss(dp, dx, cfg, carry)
            (out * distribute_tensor(ct, mesh, out.placements, src_data_rank=None)).sum().backward()
            grads = [t.grad.full_tensor() for t in [dx] + leaves(dp)]
            aux_grads = torch.autograd.grad(aux, [dx, dp["router"]])
        return out, aux, grads, [g.full_tensor() for g in aux_grads]
    def whole(p):
        p = {k: ({j: w.clone().requires_grad_() for j, w in v.items()} if isinstance(v, dict)
                 else v.clone().requires_grad_()) for k, v in p.items()}
        xx = x.clone().requires_grad_()
        out = layers.moe_ffn(p, xx, cfg, plain)
        (out * ct).sum().backward()
        grads = [t.grad for t in [xx] + leaves(p)]
        aux = layers.moe_aux_loss(p, xx, cfg, plain)
        return out, aux, grads, list(torch.autograd.grad(aux, [xx, p["router"]]))
    out, aux, grads, aux_grads = region(weights(""))
    _, w_aux, w_grads, w_aux_grads = whole(weights(""))
    kept, *_ = region(weights("blocks_"))
    got = kept.full_tensor().reshape(*kept.shape[:2], cfg.moe.num_experts, -1).abs().amax(-1) > 0
    want = np.abs(data["kept"]).reshape(*got.shape, -1).max(-1) > 0
    return {"PLACEMENTS": ",".join(str(q) for q in out.placements),
            "OUT": rel(out.full_tensor(), torch.from_numpy(data["want"])),
            "GRADS": max(rel(a, b) for a, b in zip(grads, w_grads)),
            "AUX": abs(float(aux.full_tensor()) - float(w_aux)) / float(w_aux),
            "AUX_GRADS": max(rel(a, b) for a, b in zip(aux_grads, w_aux_grads)),
            "KEPT_SAME": bool((got.numpy() == want).all()), "KEPT": int(want.sum()),
            "UNITS": want.shape[0] * want.shape[1] * cfg.moe.top_k}

for arg in sys.argv[1:]:
    name, spec = arg.split("=")
    path, group, cf = spec.split(",")
    fields = case(path, int(group), float(cf))
    print(name, " ".join(f"{k} {v}" for k, v in fields.items()), flush=True)
dist.destroy_process_group()
"""

# (moe_group_size: 4 x 64 tokens), capacity factor: 32 groups of 8 on the data
# axes, or one group of every token, replicated and split by capacity slots
MOE_CASES = {"groups-on-data": (8, 0.5), "one-group": (4096, 0.5)}


def _ref_moe_arrays(path, group, cf):
    """The reference's weights (fp32), its moe_ffn on them, and the same with
    each expert's down projection cut to its own block of output columns
    (the shared expert zeroed), written to `path` for the ranks."""
    cfg = get_reduced_config(ARCH_MOE, dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    import jax

    rp = rlayers.init_moe(jax.random.PRNGKey(11), cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    ex = rlayers.ExecConfig(moe_group_size=group)
    e, d = cfg.moe.num_experts, cfg.d_model
    block = np.zeros((e, 1, d), np.float32)
    for i in range(e):
        block[i, :, i * d // e:(i + 1) * d // e] = 1.0
    blocks = {**rp, "w_down": rp["w_down"] * block,
              "shared": {k: v * 0 for k, v in rp["shared"].items()}}
    arrays = {"x": x, "ct": ct,
              "want": np.asarray(rlayers.moe_ffn(rp, jnp.asarray(x), cfg, ex)),
              "kept": np.asarray(rlayers.moe_ffn(blocks, jnp.asarray(x), cfg, ex))}
    for prefix, p in (("", rp), ("blocks_", blocks)):
        for k, v in p.items():
            if isinstance(v, dict):
                arrays.update({f"{prefix}shared_{j}": np.asarray(w) for j, w in v.items()})
            else:
                arrays[prefix + k] = np.asarray(v)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """Rank 0's report of each case (every rank reports the same; one set of
    ranks runs both cases)."""
    args = []
    for name, (group, cf) in MOE_CASES.items():
        path = tmp_path_factory.mktemp("moe") / f"{name}.npz"
        _ref_moe_arrays(path, group, cf)
        args.append(f"{name}={path},{group},{cf}")
    cases = _by_case(run_ranks(_MOE, 4, *args, timeout=600))
    assert all(len({str(r) for r in ranks}) == 1 for ranks in cases.values()), cases
    return {name: ranks[0] for name, ranks in cases.items()}


@pytest.mark.parametrize("case", MOE_CASES)
def test_expert_parallel_moe_equals_the_reference(moe_runs, case):
    got = moe_runs[case]
    assert got["PLACEMENTS"] == CARRY, got
    assert float(got["OUT"]) < 1e-5, got            # fp32, summation order only
    assert float(got["GRADS"]) < TOL_GRAD, got
    assert got["KEPT_SAME"] == "True", got
    assert 0 < int(got["KEPT"]) < int(got["UNITS"]), got    # units were dropped


@pytest.mark.parametrize("case", MOE_CASES)
def test_aux_loss_on_local_tokens_equals_the_whole(moe_runs, case):
    got = moe_runs[case]
    assert float(got["AUX"]) < 1e-6, got
    assert float(got["AUX_GRADS"]) < TOL_GRAD, got
