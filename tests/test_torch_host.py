"""The port's copies of the reference's numpy host stack, held == to the
live reference; its config registry; and the guard that the port never
imports JAX or the reference package.

The simulator is held to the reference's live `simulate()`, not to
tests/data/golden_simulate.json, which the reference itself no longer meets.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

from _torch_parity import assert_same
from repro import configs as rconfigs
from repro.core.carbon import CHIP_DB as REF_CHIPS
from repro.serving import costs as rcosts
from repro.serving import perfmodel as rperf
from repro.serving import simulator as rsim
from repro.serving import workload as rwork
from repro_torch import configs
from repro_torch.core.carbon import CHIP_DB
from repro_torch.serving import costs, perfmodel, simulator, workload

ROOT = pathlib.Path(__file__).resolve().parents[1]

MODES = {
    "standalone": dict(name="standalone", kind="standalone", new_chip="a100"),
    "spec": dict(name="spec", kind="spec", new_chip="a100", spec_k=4, acceptance=0.7),
    "dsd": dict(name="dsd", kind="dsd", new_chip="a100", old_chip="t4", spec_k=4,
                acceptance=0.7),
    "dpd": dict(name="dpd", kind="dpd", new_chip="a100", old_chip="v100"),
}


@pytest.mark.parametrize("batching", ["serialized", "continuous"])
@pytest.mark.parametrize("kind", sorted(MODES))
def test_simulate_equals_reference(kind, batching):
    target, draft = "llama-7b", "llama-1b"
    reqs = workload.sample_mixture_requests(workload.DATASETS["sharegpt"], 2.0, 30.0, seed=4)
    rreqs = rwork.sample_mixture_requests(rwork.DATASETS["sharegpt"], 2.0, 30.0, seed=4)
    assert [dataclasses.astuple(r) for r in reqs] == [dataclasses.astuple(r) for r in rreqs]
    got = simulator.simulate(
        simulator.ServingMode(**MODES[kind]), configs.get_config(target), reqs,
        draft_cfg=configs.get_config(draft) if kind in ("spec", "dsd") else None,
        seed=7, batching=batching)
    want = rsim.simulate(
        rsim.ServingMode(**MODES[kind]), rconfigs.get_config(target), rreqs,
        draft_cfg=rconfigs.get_config(draft) if kind in ("spec", "dsd") else None,
        seed=7, batching=batching)
    assert_same(got, want)


@pytest.mark.parametrize("kind", sorted(MODES))
def test_prefill_charges_and_decode_cost_equal_reference(kind):
    new, old = "a100", ("t4" if kind in ("dsd", "dpd") else None)
    for prompt_len in (1, 37, 512, 4096):
        got = costs.prefill_charges(
            kind, configs.get_config("llama-7b"), configs.get_config("llama-1b"),
            CHIP_DB[new], CHIP_DB[old] if old else None, prompt_len)
        want = rcosts.prefill_charges(
            kind, rconfigs.get_config("llama-7b"), rconfigs.get_config("llama-1b"),
            REF_CHIPS[new], REF_CHIPS[old] if old else None, prompt_len)
        assert got.duration_s == want.duration_s
        assert [(n, dataclasses.astuple(c), t) for n, c, t in got.charges] == \
            [(n, dataclasses.astuple(c), t) for n, c, t in want.charges]
    for chip in ("a100", "t4", "v100"):
        for batch, ctx in ((1, 1), (8, 300), (64, 4096)):
            got = perfmodel.decode_cost(configs.get_config("llama-7b"), CHIP_DB[chip], batch, ctx)
            want = rperf.decode_cost(rconfigs.get_config("llama-7b"), REF_CHIPS[chip], batch, ctx)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_registry_equals_reference():
    assert list(configs._ARCH_MODULES) == list(rconfigs._ARCH_MODULES)
    assert configs.ARCH_IDS == rconfigs.ARCH_IDS
    assert configs.PAPER_MODELS == rconfigs.PAPER_MODELS
    for arch in rconfigs._ARCH_MODULES:
        got, want = configs.get_config(arch), rconfigs.get_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert got.param_count() == want.param_count()
        assert got.kv_bytes_per_token() == want.kv_bytes_per_token()
        assert got.flops_per_token(4096) == want.flops_per_token(4096)
        assert dataclasses.asdict(configs.get_reduced_config(arch)) == \
            dataclasses.asdict(rconfigs.get_reduced_config(arch))


def test_calibration_artifact_is_the_repos():
    assert perfmodel.ARTIFACT_PATH == rperf.ARTIFACT_PATH
    assert perfmodel.ARTIFACT_PATH == ROOT / "benchmarks" / "artifacts" / "kernel_calibration.json"
    assert perfmodel.ARTIFACT_PATH.exists()


_GUARD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # importing either now raises ImportError
sys.modules["repro"] = None
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_neither_jax_nor_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _GUARD, str(ROOT / "src"), str(ROOT)],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 38    # every module of the port was imported
