"""The port's dry-run (repro_torch.launch.dryrun) against the reference's
(repro.launch.dryrun), on the CPU over fake process groups.

- input_specs: the same trees, shapes and dtypes as the reference's
  ShapeDtypeStructs, for every arch and shape.
- argument_bytes: the port's per-device bytes of params, optimizer state and
  inputs equal the live reference's memory_analysis on reduced cells of the
  dense, moe, ssm and hybrid families at train, prefill and decode, on a
  (2, 4) and a (2, 2, 2) group. The reference lowers and compiles on 8 of its
  host devices in two subprocesses (one a mesh) with its SHAPES cut to 256
  tokens x 8 sequences, as this file cuts the port's.
- FLOPs: a dense prefill cell, evenly sharded, against a closed form.
- collective_bytes: the reference's HLO parser test, as records.
- cost mode: the extrapolation from 1 and 2 layers equals a full trace.
- the CLI: one arch over every shape and both production meshes in a
  subprocess with jax and repro blocked.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro import configs as rconfigs
from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun as dr

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

# the reduced cells: the reference's SHAPES cut to these (kind, seq, batch)
CUT = {"train_4k": ("train", 256, 8), "prefill_32k": ("prefill", 256, 8),
       "decode_32k": ("decode", 256, 8)}
FAMILIES = ("yi-6b", "qwen2-moe-a2.7b", "rwkv6-7b", "zamba2-2.7b")   # dense, moe, ssm, hybrid
MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


# --------------------------------------------------------------- input_specs
def _ref_leaves(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _ref_leaves(tree[key], path + (key,)).items()}
    return {"/".join(path): (tuple(tree.shape), str(tree.dtype))}


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _port_leaves(tree[key], path + (key,)).items()}
    assert tree.device.type == "meta", path
    return {"/".join(path): (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS + rconfigs.PAPER_MODELS)
def test_input_specs_equal_the_reference(arch):
    rcfg, cfg = rconfigs.get_config(arch), configs.get_config(arch)
    for shape in rconfigs.SHAPES:
        want = _ref_leaves(rconfigs.input_specs(rcfg, shape))
        got = _port_leaves(configs.input_specs(cfg, shape))
        assert got == want, (arch, shape)


# ------------------------------------------------------------ argument bytes
_REF_ARGS = r"""
import repro.launch.dryrun as d  # first: it sets the host device count
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro.configs as C
from repro.models.layers import ExecConfig
cut = json.loads(sys.argv[1])
C.SHAPES.update({k: C.ShapeSpec(k, *v) for k, v in cut.items()})
sizes, names = json.loads(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:8]).reshape(sizes), tuple(names))
out = {}
for arch in json.loads(sys.argv[3]):
    cfg = C.get_reduced_config(arch)
    for shape in cut:
        _, compiled, _ = d.lower_cell(cfg, shape, mesh, ExecConfig(static_unroll=False,
                                                                   q_block=1024))
        rec = d.analyze(compiled)
        out[f"{arch}/{shape}"] = [rec["argument_bytes"], rec["flops_per_device"],
                                  sorted(rec["collectives"])]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_argument_bytes():
    """{mesh: {arch/shape: [argument_bytes, flops_per_device, collective
    kinds]}} from the live reference, one subprocess a mesh, both at once."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {m: subprocess.Popen(
        [sys.executable, "-c", _REF_ARGS, json.dumps(CUT), json.dumps(spec),
         json.dumps(FAMILIES)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for m, spec in MESHES.items()}
    out = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-4000:]
        out[m] = json.loads(stdout.splitlines()[-1])
    return out


def _uneven(args, mesh) -> list:
    """(shape, dim, shards) of every placed tensor whose shards are uneven:
    there XLA pads every shard to rank 0's and DTensor's rank 0 holds the
    same ceil(n / shards) rows, so the bytes agree, but the case is named."""
    from repro_torch.training.optimizer import tree_leaves
    from torch.distributed.tensor import DTensor

    found = []
    for a in args:
        for t in tree_leaves(a) if isinstance(a, (dict, list)) else [a]:
            if not isinstance(t, DTensor):
                continue
            shards = {}
            for i, p in enumerate(t.placements):
                if p.is_shard():
                    shards[p.dim] = shards.get(p.dim, 1) * mesh.size(i)
            found += [(tuple(t.shape), d, n) for d, n in shards.items() if t.shape[d] % n]
    return found


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_argument_bytes_equal_the_reference(arch, mesh_name, reference_argument_bytes):
    want = reference_argument_bytes[mesh_name]
    cfg = configs.get_reduced_config(arch)
    with dr.fake_mesh(*MESHES[mesh_name]) as mesh:
        for shape, (kind, seq, batch) in CUT.items():
            _, args = dr.place_cell(cfg, ShapeSpec(shape, kind, seq, batch), mesh)
            got = dr.tensor_bytes(dr.argument_tensors(args))
            assert got == want[f"{arch}/{shape}"][0], (arch, shape, mesh_name)
            # no shard of these cells is uneven: the rules shard divisible dims only
            assert _uneven(args, mesh) == [], (arch, shape, mesh_name)


# --------------------------------------------------------------------- FLOPs
def test_prefill_flops_per_device_equal_the_closed_form():
    """A dense prefill on (data 2, model 2), every weight sharded on "model"
    (kv heads too: 8 x 128 columns), counted on rank 0's shards. The closed
    form counts 2 x M x N x K of each product (elementwise work, norms,
    softmax and RoPE are not counted): per layer, on the T = B/2 x S local
    tokens, q, k and v (d x H hd / 2 each), the scores and the value product
    of every query row against every key of its sequence (one query block:
    S <= q_block), the out projection and the three FFN products (d x F / 2
    each); then the LM head on the last token of each local sequence."""
    base = configs.get_reduced_config("yi-6b", d_model=1024, d_ff=4096, vocab_size=4096)
    cfg = dataclasses.replace(base, attn=dataclasses.replace(
        base.attn, num_heads=8, num_kv_heads=8, head_dim=128))
    b, s, dp, mp = 8, 256, 2, 2
    with dr.fake_mesh((dp, mp), ("data", "model")) as mesh:
        rec, _, _, _ = dr.lower_cell(cfg, ShapeSpec("prefill", "prefill", s, b), mesh)
    d, h, kv, hd = cfg.d_model, cfg.attn.num_heads, cfg.attn.num_kv_heads, cfg.attn.head_dim
    bl = b // dp
    t = bl * s
    per_layer = (2 * t * d * (h * hd // mp) + 2 * 2 * t * d * (kv * hd // mp)
                 + 2 * 2 * bl * (h // mp) * s * s * hd
                 + 2 * t * (h * hd // mp) * d + 3 * 2 * t * d * (cfg.d_ff // mp))
    want = cfg.num_layers * per_layer + 2 * bl * d * (cfg.vocab_size // mp)
    assert rec.flops == want


@pytest.mark.parametrize("mesh_name", MESHES)
def test_dense_flops_beside_xla(mesh_name, reference_argument_bytes, capsys):
    """Reduced yi-6b's per-device FLOPs against XLA's cost analysis of the
    reference's program, printed, with no limit: XLA counts elementwise work
    too, and the reference's sequence-parallel carry and its own attention
    blocking make other products."""
    cfg = configs.get_reduced_config("yi-6b")
    ratios = {}
    with dr.fake_mesh(*MESHES[mesh_name]) as mesh:
        for shape, (kind, seq, batch) in CUT.items():
            rec, _, _, _ = dr.lower_cell(cfg, ShapeSpec(shape, kind, seq, batch), mesh)
            xla = reference_argument_bytes[mesh_name][f"yi-6b/{shape}"][1]
            ratios[shape] = rec.flops / xla
    with capsys.disabled():
        print(f"\nyi-6b (reduced) FLOPs per device, the port's over XLA's, {mesh_name}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ratios.items()))
    assert all(v > 0 for v in ratios.values())


# ------------------------------------------------------- collectives and cost
@pytest.mark.parametrize("mesh_name", MESHES)
def test_sharded_cells_record_their_collectives(mesh_name, reference_argument_bytes, capsys):
    """The dense and moe reduced train and prefill cells run sequence-
    parallel (their 256 tokens divide "model"), as the reference's do; the
    moe's 4 experts split over the data axes, so its dispatch goes through
    the all-to-all and the record says so. The port's collective kinds are
    printed beside those XLA chose for the reference's program."""
    lines = []
    with dr.fake_mesh(*MESHES[mesh_name]) as mesh:
        for arch in ("yi-6b", "qwen2-moe-a2.7b"):
            cfg = configs.get_reduced_config(arch)
            for shape in ("train_4k", "prefill_32k"):
                spec = ShapeSpec(shape, *CUT[shape])
                ex = dr.cell_exec(cfg, spec, mesh)
                rec = dr.analyze(*dr.lower_cell(cfg, spec, mesh)[:3], ex)
                xla = reference_argument_bytes[mesh_name][f"{arch}/{shape}"][2]
                lines.append(f"{arch}/{shape}: port {sorted(rec['collectives'])}, "
                             f"XLA {xla}, expert_parallel_dispatch "
                             f"{rec['expert_parallel_dispatch']}")
                assert rec["seq_parallel"] and ex.carry_spec[1] == "model", (arch, shape)
                assert rec["expert_parallel_dispatch"] == (arch == "qwen2-moe-a2.7b"), (arch, shape)
                if rec["expert_parallel_dispatch"]:
                    assert "all-to-all" in rec["collectives"], (arch, shape, rec["collectives"])
                assert "reduce-scatter" in rec["collectives"], (arch, shape)
    with capsys.disabled():
        print(f"\ncollective kinds, reduced cells on {mesh_name}:\n  " + "\n  ".join(lines))


def test_collective_bytes_match_the_reference_parser():
    """tests/test_property.py::test_collective_bytes_parser's HLO, as the
    records the port reads off its collectives."""
    got = dr.collective_bytes([
        ("all-gather", [(torch.bfloat16, (2, 128))]),
        ("all-reduce", [(torch.float32, (64,))]),
        ("reduce-scatter", [(torch.float32, (4, 4))]),
        ("collective-permute", [(torch.uint8, (1024,))]),
        ("all-to-all", [(torch.float32, (8,)), (torch.float32, (8,))]),
    ])
    assert got["all-gather"]["bytes"] == 2 * 128 * 2
    assert got["all-reduce"]["bytes"] == 64 * 4 * 2          # ring 2x
    assert got["reduce-scatter"]["bytes"] == 16 * 4
    assert got["collective-permute"]["bytes"] == 1024
    assert got["all-to-all"]["bytes"] == 8 * 4 * 2
    assert sum(c["count"] for c in got.values()) == 5
    assert dr.collective_kind("_c10d_functional.all_gather_into_tensor") == "all-gather"
    assert dr.collective_kind("c10d.allreduce_") == "all-reduce"
    assert dr.collective_kind("_c10d_functional.wait_tensor") is None


def test_cost_mode_extrapolation_equals_the_full_trace(monkeypatch):
    """Reduced yi-6b at 4 layers, train: cost mode's line through 1 and 2
    layers lands exactly on the count of a trace of all 4 (every layer runs
    the same ops on the same shapes)."""
    cfg = configs.get_reduced_config("yi-6b", num_layers=4)
    monkeypatch.setitem(configs.SHAPES, "train_4k", ShapeSpec("train_4k", "train", 128, 8))
    with dr.fake_mesh((2, 4), ("data", "model")) as mesh:
        cost = dr.measure(cfg, "train_4k", mesh, "cost")
        rec, arg, out, _ = dr.lower_cell(cfg, "train_4k", mesh)
    full = dr.analyze(rec, arg, out)
    assert cost["extrapolated_from_layers"] == [1, 2]
    for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                "argument_bytes"):
        assert cost[key] == full[key], key


# ------------------------------------------------------------------------ CLI
_BLOCKED = r"""
import runpy, sys
sys.modules["jax"] = None          # importing either now raises ImportError
sys.modules["repro"] = None
sys.argv = ["dryrun", *sys.argv[1:]]
runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
"""


def test_cli_runs_one_arch_over_every_shape_and_both_meshes(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, "--arch", "yi-6b", "--shape", "all", "--mesh", "both",
         "--out", str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1].startswith("done: 6 ok, 2 documented skips, 0 errors")
    cells = json.loads(out.read_text())["cells"]
    assert sorted(k for k, v in cells.items() if v["status"] == "skip") == [
        "yi-6b/long_500k/multi_pod/proof", "yi-6b/long_500k/single_pod/proof"]
    for key, rec in cells.items():
        if rec["status"] == "ok":
            assert rec["devices"] == (512 if "multi_pod" in key else 256), key
            assert rec["argument_bytes"] > 0 and rec["flops_per_device"] > 0, key
            # the reference's rule: train and prefill cells whose sequence
            # divides "model" (4096 and 32768 over 16) are sequence-parallel
            kind = configs.SHAPES[key.split("/")[1]].kind
            assert rec["seq_parallel"] is (kind in ("train", "prefill")), key
            assert rec["expert_parallel_dispatch"] is False, key      # dense
