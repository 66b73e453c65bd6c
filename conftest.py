"""How the tier-1 suite is spread over xdist workers (`-n N --dist loadfile`).

A serial run, or one under another `--dist` mode, is left as it is."""
import os

import pytest

# Under `--dist loadfile` each file is one unit of work, held by one worker,
# and xdist hands out the files with the most tests first. These files go
# out first instead, longest first; the rest follow in xdist's own order.
# The seconds are each file's in a whole run of the suite, 6 workers on an
# 8-core CPU host, with torch's threads capped as pytest_configure does
# (mean of two runs).
HEAVIEST_FIRST = (
    "tests/test_paged_engine.py",  # 798
    "tests/test_spec_decode.py",  # 380
    "tests/test_engine_sim_parity.py",  # 361
    "tests/test_torch_spec_engine.py",  # 315
    "tests/test_models_smoke.py",  # 276
    "tests/test_torch_examples.py",  # 273
    "tests/test_torch_dryrun.py",  # 204
)


def heaviest_first(workqueue):
    """Move HEAVIEST_FIRST's files to the front of xdist's queue, in order."""
    for scope in reversed(HEAVIEST_FIRST):
        if scope in workqueue:
            workqueue.move_to_end(scope, last=False)


def pytest_configure():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        # Each xdist worker would size torch's pool to every core it may use.
        import torch

        workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class HeaviestFirstFileScheduling(LoadFileScheduling):
        def _assign_work_unit(self, node):
            heaviest_first(self.workqueue)
            super()._assign_work_unit(node)

    return HeaviestFirstFileScheduling(config, log)
