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


@pytest.mark.parametrize("name", ["serve_disaggregated", "carbon_planner", "fleet_allocate",
                                  "autoscale"])
def test_planning_example_prints_the_reference_output(name):
    port = _start(["-c", _BLOCKED, str(EXAMPLES / f"torch_{name}.py")])
    ref = _start([str(EXAMPLES / f"{name}.py")])      # both run at once
    got, want = _finish(port, f"torch_{name}.py"), _finish(ref, f"{name}.py")
    assert len(want.splitlines()) > 10
    assert got.splitlines() == want.splitlines()


def test_quickstart_serves_every_kind_on_the_cpu():
    out = _finish(_start(["-c", _BLOCKED, str(EXAMPLES / "torch_quickstart.py"),
                          "--device", "cpu"]), "torch_quickstart.py")
    rows = [ln.split()[0] for ln in out.splitlines()[1:5]]
    assert rows == ["standalone", "spec", "dpd+v100", "dsd+t4"]
    assert "token-identical: True (forwards on cpu)" in out


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
    assert not found, found
