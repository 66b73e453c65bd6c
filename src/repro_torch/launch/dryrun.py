"""Multi-pod dry-run of the port; the counterpart of src/repro/launch/dryrun.py.

Runs every (architecture x input shape x mesh) cell's step on one process
that plays rank 0 of a fake process group of 256 ranks (single pod, (16, 16)
= ("data", "model")) or 512 (multi-pod, (2, 16, 16) = ("pod", "data",
"model")), and records what one device would hold and do. Nothing is
allocated: parameters, optimizer state and inputs are tensors on the `meta`
device, placed as DTensors by the port's own sharding rules, and the fake
group's collectives move nothing.

What each shape kind runs:
  train    the sharded step (training.train_step `shard_params`,
           `shard_opt_state`, `make_sharded_train_step`) with AdamW, remat,
           and the reference's microbatch rule in proof mode;
  prefill  backbone.prefill over the sharded params and batch;
  decode   backbone.serve_step on the cache that `cache_pspecs` places.
All with use_kernels=False: the kernels have no meta path (and no backward).

A dispatch mode below DTensor sees each op on the local shards, and from
them counts, per device:
  flops_per_device   multiply-adds x 2 of the products (torch's FLOP
                     formulas; elementwise work is not counted);
  bytes_per_device   bytes read and written by every op that is not a view
                     or a collective;
  argument_bytes     local shard bytes of params, state and inputs;
  output_bytes       local bytes of what the step returns (the train step
                     updates params and state in place, so they count here
                     too);
  temp_bytes         the peak of live local bytes during the step beyond
                     the arguments (storages tracked from birth to death);
  collectives        the result bytes of each collective by the reference's
                     kind names, all-reduce counted twice (a ring's reduce-
                     scatter and all-gather).
The fit is judged against an NVIDIA H100 80GB HBM3 (`hbm_bytes`): the
card's own total memory where a card is present, else NVIDIA's data-sheet
80 GB.

Modes
-----
proof  every layer traced, on both meshes; the record proves the sharding
       rules coherent (no DTensor op without a rule) and gives the fit.
cost   single-pod only, at 1 and 2 layer units (zamba2's unit is its tap
       group of 6 Mamba2 layers and the shared attention), extrapolated
       linearly to the full depth, as the reference does. A trace of every
       layer counts the same (the port has no lax.scan): the extrapolation
       only saves time.

Train and prefill cells whose sequence divides the "model" axis run, as
the reference's `lower_cell` sets them, with the sequence-parallel residual
stream (ExecConfig.carry_spec = (data axes, "model", None): each layer's
output sharded on its sequence over "model", reduce-scattered onto it and
gathered after each norm) and, for the MoE, the expert-parallel dispatch
(ExecConfig.ep_axes = sharding.ep_axes_for(mesh, E), where those axes
divide the experts: one all-to-all each way, which the fake group's
`alltoall_base` performs and the records count under "all-to-all"; the
MoE's groups on the data axes; distributed/tensor_parallel.py
`expert_parallel_region`). "seq_parallel" and "expert_parallel_dispatch"
record what was set. Decode cells run without either, as in the reference.

Usage:
    python -m repro_torch.launch.dryrun --mode proof --arch all --shape all --mesh both
    python -m repro_torch.launch.dryrun --mode cost  --arch yi-34b --shape train_4k
Records accumulate in build/repro_torch/dryrun.json (or --out).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    cell_is_runnable,
    get_config,
    input_specs,
)
from repro_torch.distributed import sharding
from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.models.layers import TRAIN_EXEC, ExecConfig
from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_leaves, tree_map
from repro_torch.training.train_step import (
    make_sharded_train_step,
    shard_batch,
    shard_opt_state,
    shard_params,
)

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun.json"
# NVIDIA's H100 SXM data sheet: 80 GB of HBM3; on a card, its own total
H100_HBM_BYTES = 80 * 10**9

_KINDS = {"all_gather": "all-gather", "allgather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_reduce": "all-reduce",
          "allreduce": "all-reduce", "all_to_all": "all-to-all", "alltoall": "all-to-all",
          "send": "collective-permute", "recv": "collective-permute"}


def hbm_bytes() -> tuple[int, str]:
    """(bytes, source) of the memory a cell must fit."""
    if torch.cuda.is_available():
        p = torch.cuda.get_device_properties(0)
        return p.total_memory, f"{p.name} total_memory"
    return H100_HBM_BYTES, "NVIDIA H100 80GB HBM3 data sheet (no card present)"


# ---------------------------------------------------------------------------
# collective bytes
# ---------------------------------------------------------------------------
def collective_kind(op_name: str) -> str | None:
    """The reference's kind name of a c10d op (`_c10d_functional.all_gather_
    into_tensor`, `c10d.allreduce_`, ...), or None for a non-collective
    (wait_tensor, barrier)."""
    ns, _, name = op_name.partition(".")
    if ns not in ("_c10d_functional", "c10d"):
        return None
    for key, kind in _KINDS.items():
        if name.startswith(key):
            return kind
    return None


def collective_bytes(records) -> dict:
    """Per-device collective payload bytes by kind, from records (kind,
    [(dtype, shape), ...]): each the result tensors of one collective (a
    tuple result lists several), all-reduce weighted 2x for the ring's send
    and receive, as the reference's HLO parser counts."""
    out: dict[str, dict[str, float]] = {}
    for kind, results in records:
        nbytes = 0
        for dtype, shape in results:
            n = 1
            for d in shape:
                n *= int(d)
            nbytes += n * dtype.itemsize
        if kind == "all-reduce":
            nbytes *= 2
        rec = out.setdefault(kind, {"count": 0, "bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += nbytes
    return out


# ---------------------------------------------------------------------------
# the recorder: every op on the local shards
# ---------------------------------------------------------------------------
def _tensors(x, out: list) -> list:
    """The tensors in an op's arguments or result (tensors, lists, tuples,
    dicts), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _meta_tensors(ts: list) -> list:
    return [t for t in ts if type(t) is torch.Tensor and t.device.type == "meta"]


def local_tensors(tree) -> list:
    """The local shards of a tree's DTensors (and its plain tensors)."""
    out = []
    for t in tree_leaves(tree) if isinstance(tree, (dict, list)) else [tree]:
        if isinstance(t, DTensor):
            out.append(t.to_local())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def tensor_bytes(tensors) -> int:
    """Bytes of distinct storages."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class Recorder(TorchDispatchMode):
    """Sees what one rank runs: DTensor ops are passed on (NotImplemented),
    so the mode meets their local ops on meta tensors. Ops on FakeTensors
    (DTensor's shape propagation) and on real CPU tensors (its index
    bookkeeping) are not the step's and are skipped. Counts FLOPs, bytes
    moved and collectives, and the live bytes of meta storages from their
    first appearance to their death."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.colls: list = []
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}

    def hold(self, tensors) -> None:
        """Count these storages as live (the step's arguments)."""
        for t in tensors:
            self._track(t)

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors(kwargs, _tensors(args, [])), _tensors(out, [])
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out
        ins, outs = _meta_tensors(ins), _meta_tensors(outs)
        if not (ins or outs):
            return out
        name = f"{func.namespace}.{func._opname}"
        kind = collective_kind(name)
        if kind is not None:
            self.colls.append((kind, [(t.dtype, tuple(t.shape)) for t in outs]))
        elif func.namespace not in ("_c10d_functional", "c10d") and not func.is_view:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


# ---------------------------------------------------------------------------
# the fake group, its mesh, the stand-ins
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_mesh(sizes: tuple[int, ...], names: tuple[str, ...]):
    """A DeviceMesh of `sizes` over a fake process group of prod(sizes)
    ranks, this process rank 0; the group is destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run needs its own fake process group; one exists")
    world = 1
    for n in sizes:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield init_device_mesh("cpu", sizes, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def production_mesh(name: str):
    """fake_mesh of launch.mesh's production shape: "single_pod" (16, 16) or
    "multi_pod" (2, 16, 16)."""
    m = make_production_mesh(multi_pod=name == "multi_pod")
    return fake_mesh(m.sizes, m.axis_names)


def abstract_params(cfg: ModelConfig):
    """The params tree of `cfg` as meta tensors (shapes and dtypes of
    backbone.init_params; the draws happen on fake tensors)."""
    with FakeTensorMode():
        fake = backbone.init_params(torch.Generator().manual_seed(0), cfg)
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def microbatches(cfg: ModelConfig) -> int:
    """The reference's proof-mode rule (dryrun.py): 4 above 40 B params, 2
    above 12 B; the recurrent families at least 2 (ssm) and 4 (hybrid)."""
    n = cfg.param_count()
    mb = 4 if n > 4e10 else (2 if n > 1.2e10 else 1)
    if cfg.family == "hybrid":
        mb = max(mb, 4)
    elif cfg.family == "ssm":
        mb = max(mb, 2)
    return mb


def _place(tree: dict, specs: dict, mesh) -> dict:
    return {k: sharding.distribute(v, mesh, specs[k]) for k, v in tree.items()}


def shape_spec(shape) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def cell_exec(cfg: ModelConfig, shape, mesh) -> ExecConfig:
    """The cell's ExecConfig: the reference's training mode (TRAIN_EXEC: no
    kernel, remat, query blocks of 1024, as its dry-run's ExecConfig), and,
    as its `lower_cell` sets them, for train and prefill cells whose
    sequence divides "model", the sequence-parallel carry over (data axes,
    "model", None) and the MoE's expert-parallel axes."""
    sp = shape_spec(shape)
    model = sharding.mesh_axes(mesh).get("model", 1)
    if sp.kind not in ("train", "prefill") or sp.seq_len % model:
        return TRAIN_EXEC
    ep = sharding.ep_axes_for(mesh, cfg.moe.num_experts) if cfg.moe else None
    return dataclasses.replace(TRAIN_EXEC, carry_spec=(batch_axes(mesh), "model", None),
                               ep_axes=ep)


def place_cell(cfg: ModelConfig, shape, mesh, mb: int = 1):
    """The cell's step and its arguments placed on `mesh` as the port's
    sharding rules place them (meta local shards), run under `cell_exec`.
    `shape` is a name of SHAPES or a ShapeSpec. Returns (step, args)."""
    spec = input_specs(cfg, shape)
    kind = shape_spec(shape).kind
    ex = cell_exec(cfg, shape, mesh)
    params = abstract_params(cfg)
    sp = shard_params(params, mesh)
    if kind == "train":
        so = shard_opt_state(init_opt_state(params), params, mesh)
        step = make_sharded_train_step(mesh, cfg, AdamWConfig(), ex, microbatches=mb)
        return step, (sp, so, shard_batch(spec["batch"], mesh))
    if kind == "prefill":
        def prefill(p, b):
            with implicit_replication(), torch.no_grad():
                return backbone.prefill(p, b, cfg, ex)
        return prefill, (sp, shard_batch(spec["batch"], mesh))
    cache = _place(spec["cache"], sharding.cache_pspecs(spec["cache"], cfg, mesh), mesh)
    extra = {k: spec[k] for k in ("tokens", "embeds") if k in spec}
    extra = _place(extra, {k: sharding.tokens_pspec(v.shape, mesh) for k, v in extra.items()},
                   mesh)

    def decode(p, c, t, e):
        with implicit_replication(), torch.no_grad():
            return backbone.serve_step(p, c, t, cfg, ex, embeds=e)
    return decode, (sp, cache, extra["tokens"], extra.get("embeds"))


def argument_tensors(args) -> list:
    return [t for a in args if a is not None for t in local_tensors(a)]


def lower_cell(cfg: ModelConfig, shape, mesh, mb: int = 1) -> tuple[Recorder, int, int, dict]:
    """Place the cell's stand-ins on `mesh` and run its step under a
    Recorder. Returns (recorder, argument_bytes, output_bytes, timings)."""
    t0 = time.perf_counter()
    step, args = place_cell(cfg, shape, mesh, mb)
    held = argument_tensors(args)
    argument_bytes = tensor_bytes(held)
    t1 = time.perf_counter()
    rec = Recorder()
    rec.hold(held)
    del held
    with rec:
        out = step(*args)
    output_bytes = tensor_bytes([t for o in out for t in local_tensors(o)])
    del out, args
    t2 = time.perf_counter()
    return rec, argument_bytes, output_bytes, {"setup_s": round(t1 - t0, 2),
                                               "trace_s": round(t2 - t1, 2)}


def analyze(rec: Recorder, argument_bytes: int, output_bytes: int,
            exec_cfg: ExecConfig = TRAIN_EXEC) -> dict:
    """One lowered cell's record; exec_cfg is the ExecConfig it ran under."""
    colls = collective_bytes(rec.colls)
    memory, source = hbm_bytes()
    return {
        "flops_per_device": float(rec.flops),
        "bytes_per_device": float(rec.bytes),
        "argument_bytes": argument_bytes,
        "output_bytes": output_bytes,
        "temp_bytes": rec.peak - argument_bytes,
        "peak_bytes": rec.peak,
        "hbm_bytes": memory,
        "hbm_source": source,
        "fits_hbm": rec.peak <= memory,
        "collectives": colls,
        "collective_bytes_per_device": sum(c["bytes"] for c in colls.values()),
        **_sharding_flags(exec_cfg),
    }


def _sharding_flags(exec_cfg: ExecConfig) -> dict:
    return {"seq_parallel": exec_cfg.carry_spec is not None,
            "expert_parallel_dispatch": exec_cfg.ep_axes is not None}


def _unit_layers(cfg: ModelConfig) -> int:
    return cfg.hybrid_attn_every if cfg.family == "hybrid" else 1


def measure(cfg: ModelConfig, shape: str, mesh, mode: str) -> dict:
    """One cell's record on a built mesh (a proof or a cost pass)."""
    devices = mesh.size()
    ex = cell_exec(cfg, shape, mesh)
    if mode == "proof":
        mb = microbatches(cfg) if shape_spec(shape).kind == "train" else 1
        rec, arg, out, times = lower_cell(cfg, shape, mesh, mb)
        return {"status": "ok", "devices": devices, "microbatches": mb, **times,
                **analyze(rec, arg, out, ex)}
    unit = _unit_layers(cfg)
    results, times_all = {}, {}
    for mult in (1, 2):
        small = dataclasses.replace(cfg, num_layers=unit * mult)
        rec, arg, out, times = lower_cell(small, shape, mesh)
        results[mult] = analyze(rec, arg, out, ex)
        times_all[f"trace_s_L{unit * mult}"] = times["trace_s"]
    n_units = cfg.num_layers // unit
    rec = {"status": "ok", "devices": devices,
           "extrapolated_from_layers": [unit, 2 * unit], **times_all}
    for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                "argument_bytes"):
        per_unit = results[2][key] - results[1][key]
        rec[key] = results[1][key] + per_unit * (n_units - 1)
    rec["collectives"] = results[2]["collectives"]
    rec.update(_sharding_flags(ex))
    return rec


def run_cell(arch: str, shape: str, mesh, mode: str) -> dict:
    """The record of (arch, shape) on a built mesh: a documented skip, an
    ok cell, or the error that stopped it."""
    cfg = get_config(arch)
    ok, reason = cell_is_runnable(cfg, shape)
    if not ok:
        return {"status": "skip", "reason": reason}
    try:
        return measure(cfg, shape, mesh, mode)
    except Exception as e:  # noqa: BLE001 - a failed cell IS the signal
        return {"status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


# ---------------------------------------------------------------------------
def _line(key: str, rec: dict, secs: float) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok":
        extra = (f" flops/dev={rec.get('flops_per_device', 0):.3e}"
                 f" coll/dev={rec.get('collective_bytes_per_device', 0):.3e}B"
                 f" arg={rec.get('argument_bytes', 0) / 2**30:.2f}GiB")
        if "temp_bytes" in rec:
            extra += (f" temp={rec['temp_bytes'] / 2**30:.2f}GiB"
                      f" fits={rec['fits_hbm']}")
    elif status == "error":
        extra = " " + rec["error"][:120]
    return f"[{status}] {key} ({secs:.1f}s){extra}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--mode", default="proof", choices=["proof", "cost"])
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single_pod", "multi_pod"] if args.mesh == "both" else [args.mesh]
    if args.mode == "cost":
        meshes = ["single_pod"]  # the roofline table is single-pod

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    artifacts = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            artifacts = json.load(f)
    cells = artifacts.setdefault("cells", {})

    n_ok = n_skip = n_err = 0
    t_all = time.perf_counter()
    for mesh_name in meshes:
        with production_mesh(mesh_name) as mesh:
            for arch in archs:
                for shape in shapes:
                    key = f"{arch}/{shape}/{mesh_name}/{args.mode}"
                    if key in cells and cells[key]["status"] == "ok" and not args.force:
                        print(f"[cached] {key}")
                        n_ok += 1
                        continue
                    t0 = time.perf_counter()
                    rec = run_cell(arch, shape, mesh, args.mode)
                    secs = time.perf_counter() - t0
                    if rec["status"] != "skip":
                        rec["cell_s"] = round(secs, 2)
                    cells[key] = rec
                    with open(args.out, "w") as f:
                        json.dump(artifacts, f, indent=1)
                    n_ok += rec["status"] == "ok"
                    n_skip += rec["status"] == "skip"
                    n_err += rec["status"] == "error"
                    print(_line(key, rec, secs), flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} documented skips, {n_err} errors "
          f"({time.perf_counter() - t_all:.1f} s)")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
