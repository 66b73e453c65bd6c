"""Nothing the benchmark runs loads JAX or the JAX package.

The top-level name of every module is compared whole: the program's package,
repro_torch, begins with the JAX package's name, repro, and is allowed; the
plain reference imports nothing of the program either."""
import ast
import os
import subprocess
import sys

import perfbench_cases as cases
import pytest

ROOT = cases.ROOT
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_sees_every_entry_and_reader():
    rel = {str(p.relative_to(BENCH)) for p in SOURCES}
    assert {"run.py", "sweep.py", "calibrate.py", "reference/model.py",
            "metrics/ttft_p95_ms.py", "metrics/mfu.lat.py", "harness/check.py",
            "families/dense.py", "families/moe.py"} <= rel


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_names_jax_or_the_jax_package(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names
    if "reference" in path.relative_to(BENCH).parts:
        assert names <= {"__future__", "torch", "numpy", "math"}, names


# the subprocesses' tiny models gain nothing from threads, which a busy host
# (the test suite's other workers) turns into waiting
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")

BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "repro"}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def test_a_run_with_jax_and_the_jax_package_blocked():
    """run.py, the readers, sweep.py and calibrate.py import, and a whole
    reduced run goes through, where importing jax or repro raises."""
    code = BLOCK + """
sys.path[:0] = ["perfbench/tests", "perfbench"]
import perfbench_cases as c
r = c.run_module()
""" + cases.FAKE_CLOCK_CODE + """
import sweep, calibrate
from perfbench.harness import spec
for m in c.cell("yi-6b").end_to_end + c.cell("qwen2-moe-a2.7b", "backlog").per_layer:
    spec.reader(m.name)
out = r.run_cell(c.cell("qwen2-moe-a2.7b", max_batch=8), 5, 1.0, True, "cpu")
print("correct", out["correct"], "loaded", r.forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=400, env=ONE_THREAD)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "correct True loaded []"


def test_a_loaded_jax_module_stops_the_result():
    code = """
import sys, types
sys.path[:0] = ["perfbench/tests"]
import perfbench_cases as c
r = c.run_module()
""" + cases.FAKE_CLOCK_CODE + """
sys.modules["jax"] = types.ModuleType("jax")
print("result", r.run_cell(c.cell("yi-6b"), 5, 0.5, False, "cpu"))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=400, env=ONE_THREAD)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "result None"
    assert "['jax']" in p.stderr
