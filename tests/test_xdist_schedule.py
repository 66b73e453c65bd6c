"""The xdist set-up of the repo's root conftest.py: that the heaviest files
go out first, whole, and torch's thread cap in a worker. No workers run
here: the scheduler is driven with a fake config and fake nodes, and the
cap with a fake torch."""
import importlib.util
import os
import sys
from collections import OrderedDict
from pathlib import Path
from types import SimpleNamespace

import pytest

# loaded by path: `conftest` in sys.modules is whichever conftest came last
_spec = importlib.util.spec_from_file_location(
    "root_conftest", Path(__file__).parents[1] / "conftest.py")
_root = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_root)
HEAVIEST_FIRST, heaviest_first = _root.HEAVIEST_FIRST, _root.heaviest_first
pytest_configure = _root.pytest_configure
pytest_xdist_make_scheduler = _root.pytest_xdist_make_scheduler

WHOLE = "tests/test_kernels.py"  # a file the tuple does not name


def _queue(scopes):
    return OrderedDict((s, {f"{s}::test_{i}": False for i in range(3)})
                       for s in scopes)


PRESENT = pytest.mark.parametrize(
    "present", [slice(None), slice(1, None, 2), slice(0)],
    ids=["all", "every_other", "none"])


def _reordered(present):
    heavy = list(HEAVIEST_FIRST[present])
    others = [f"tests/test_other_{i}.py" for i in range(4)]
    # xdist's own order, with the heavy files late and reversed
    before = others[:2] + heavy[::-1] + others[2:]
    queue = _queue(before)
    heaviest_first(queue)
    return queue, before, heavy + others


@PRESENT
def test_heaviest_first(present):
    queue, before, after = _reordered(present)
    assert list(queue) == after
    assert dict(queue) == dict(_queue(before))


@PRESENT
def test_heaviest_first_again_changes_nothing(present):
    # the scheduler calls it before each unit it hands out
    queue, _, after = _reordered(present)
    heaviest_first(queue)
    assert list(queue) == after


class _Node:
    shutting_down = False

    def __init__(self, name, sent):
        self.gateway = SimpleNamespace(id=name)
        self.sent = sent

    def send_runtest_some(self, indices):
        self.sent.append((self, indices))

    def shutdown(self):
        self.shutting_down = True


class _Config:
    def __init__(self, dist, nodes):
        self.option = SimpleNamespace(dist=dist, tx=[f"{nodes}*popen"],
                                      loadscopereorder=True)

    def getvalue(self, name):
        return getattr(self.option, name)


@pytest.mark.parametrize("dist", ["load", "loadscope", "loadgroup", "each",
                                  "worksteal", "no"])
def test_other_modes_keep_xdist_scheduler(dist):
    assert pytest_xdist_make_scheduler(_Config(dist, 2), None) is None


def _schedule(workers):
    """Run the scheduler over fake nodes that each run what they were sent,
    in turn; return the collection and the (node, indices) sent."""
    # a file with more tests than any listed file: xdist alone sends it first
    collection = [f"{WHOLE}::test_{i}" for i in range(9)]
    for f in reversed(HEAVIEST_FIRST):
        collection += [f"{f}::test_x[1]", f"{f}::test_x[2]", f"{f}::test_y"]
    sched = pytest_xdist_make_scheduler(_Config("loadfile", workers), None)
    sent = []
    nodes = [_Node(f"gw{i}", sent) for i in range(workers)]
    for node in nodes:
        sched.add_node(node)
    for node in nodes:
        sched.add_node_collection(node, collection)
    sched.schedule()
    done = 0
    while done < len(sent):
        node, indices = sent[done]
        done += 1
        for i in indices:
            sched.mark_test_complete(node, i)
    assert sched.tests_finished
    return collection, sent


def _file(nodeid):
    return nodeid.partition("::")[0]


@pytest.mark.parametrize("workers", [1, 2, 3, 6, 8])
def test_scheduler_sends_heaviest_files_first_and_each_test_once(workers):
    collection, sent = _schedule(workers)
    order = [i for _, indices in sent for i in indices]
    assert sorted(order) == list(range(len(collection)))
    files = list(dict.fromkeys(_file(collection[i]) for i in order))
    assert files == list(HEAVIEST_FIRST) + [WHOLE]


@pytest.mark.parametrize("workers", [2, 3, 6])
def test_a_file_stays_on_one_worker(workers):
    # its module fixtures are built once
    collection, sent = _schedule(workers)
    held = {}
    for node, indices in sent:
        for i in indices:
            held.setdefault(_file(collection[i]), set()).add(node)
    assert set(held) == set(HEAVIEST_FIRST) | {WHOLE}
    assert all(len(nodes) == 1 for nodes in held.values())


@pytest.mark.parametrize("worker, count, cores, threads", [
    ("gw0", "6", 8, 1),
    ("gw5", "6", 32, 5),
    ("gw0", "6", 4, 1),
    ("gw3", "1", 8, 8),
    (None, None, 8, None),  # not a worker: torch keeps its own count
])
def test_a_worker_caps_torch_threads(monkeypatch, worker, count, cores,
                                     threads):
    for name, value in (("PYTEST_XDIST_WORKER", worker),
                        ("PYTEST_XDIST_WORKER_COUNT", count)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    # the cores this process may run on, not every core of the host
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cores)))
    calls = []
    monkeypatch.setitem(sys.modules, "torch",
                        SimpleNamespace(set_num_threads=calls.append))
    pytest_configure()
    assert calls == ([threads] if threads else [])
