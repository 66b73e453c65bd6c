"""The port's example scripts run with JAX and the reference package blocked,
and its planning examples print exactly what the reference's print.

Each example runs in a subprocess of its own. Blocking the imports there
also catches an import of the reference left inside a function: the
in-process parity tests would run the reference's code through it without
noticing, since the reference is importable beside the port. Every import
statement of the port, lazy ones included, is also read from its source.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

_BLOCKED = r"""
import runpy, sys
sys.modules["jax"] = None          # importing either now raises ImportError
sys.modules["repro"] = None
path, sys.argv = sys.argv[1], sys.argv[1:]
runpy.run_path(path, run_name="__main__")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
"""


def _start(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)


def _finish(proc, what):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, f"{what}:\n{err}"
    return out


# batching_burst prints its table of 2 policies in 8 lines; the others more
_MIN_LINES = {"batching_burst": 8}


@pytest.mark.parametrize("name", ["serve_disaggregated", "carbon_planner", "fleet_allocate",
                                  "autoscale", "batching_burst", "priority_mix"])
def test_planning_example_prints_the_reference_output(name):
    port = _start(["-c", _BLOCKED, str(EXAMPLES / f"torch_{name}.py")])
    ref = _start([str(EXAMPLES / f"{name}.py")])      # both run at once
    got, want = _finish(port, f"torch_{name}.py"), _finish(ref, f"{name}.py")
    assert len(want.splitlines()) >= _MIN_LINES.get(name, 11)
    assert got.splitlines() == want.splitlines()


def test_quickstart_serves_every_kind_on_the_cpu():
    out = _finish(_start(["-c", _BLOCKED, str(EXAMPLES / "torch_quickstart.py"),
                          "--device", "cpu"]), "torch_quickstart.py")
    rows = [ln.split()[0] for ln in out.splitlines()[1:5]]
    assert rows == ["standalone", "spec", "dpd+v100", "dsd+t4"]
    assert "token-identical: True (forwards on cpu)" in out


_ELASTIC = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.argv = ["torch_train_elastic.py", *sys.argv[1:]]
runpy.run_path(%r, run_name="__main__")
""" % str(EXAMPLES / "torch_train_elastic.py")


def test_train_elastic_survives_the_failure_on_4_gloo_ranks():
    """examples/torch_train_elastic.py as torchrun would start it, 4 ranks on
    gloo: 2 drop at step 6, the other 2 restore the step-6 checkpoint on a
    1 x 2 mesh and go on to step 12 with the loss lower than at step 1."""
    from _torch_dist import run_ranks

    outs = run_ranks(_ELASTIC, 4, "--device", "cpu", "--steps", "12", "--fail-at", "6",
                     "--ckpt-every", "3", "--print-every", "1", timeout=300)
    lines = outs[0].splitlines()
    assert lines[0] == "mesh {'data': 2, 'model': 2}; training glm4-9b-reduced (1.2M params)"
    steps = [ln.split() for ln in lines if ln.startswith("  step")]
    assert [int(s[1]) for s in steps] == list(range(1, 13))
    assert [" ".join(s[4:]) for s in steps] == (["mesh {'data': 2, 'model': 2}"] * 6
                                                + ["mesh {'data': 1, 'model': 2}"] * 6)
    assert "survived the step-6 failure (4 -> 2 ranks), mesh now {'data': 1, 'model': 2}" \
        in lines
    first, last = (float(x) for x in lines[-1].split()[1:4:2])
    assert lines[-1].endswith("over 12 steps") and last < first
    assert all(out == "" for out in outs[1:])   # rank 0 prints


def _sources():
    return [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")), ROOT / "chip_smoke.py",
            *sorted(EXAMPLES.glob("torch_*.py"))]


def test_no_import_of_the_reference_or_jax_in_the_port():
    """Every import statement of the port, at any depth (a lazy one inside a
    function included), names neither the reference nor JAX, nor ml_dtypes
    (the card's machine has none of them)."""
    found = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else []
            found += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                      if n.split(".")[0] in ("repro", "jax", "jaxlib", "ml_dtypes")]
    assert len(_sources()) > 40
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    assert {"src/repro_torch/launch/dryrun.py", "src/repro_torch/kernels/smem.py",
            "src/repro_torch/configs/__init__.py"} <= scanned
    assert not found, found
