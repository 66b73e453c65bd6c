"""The port's elastic trainer over torch.distributed (gloo, CPU processes),
through its launcher, and the launcher's lines against the reference's.

- `launch.train` on 4 ranks (as torchrun would start them) with model axis
  2 drops the last 2 at step 4; the survivors build a 1 x 2 mesh over
  themselves, restore the checkpoint of step 4 and reach step 8, and the
  dropped ranks leave.
- `launch.train --device cpu` prints the reference launcher's lines (its
  header, one line a step, the closing line), numbers aside: each package
  draws its own weights. Both launchers run at once, each in a subprocess.
"""
import os
import re
import sys

from _torch_dist import SRC, Process, run_ranks

WORLD = 4


_LAUNCH = """
from repro_torch.launch.train import main
main()
"""
_STEP_LINE = re.compile(r"^  step +(\d+) loss [-\d.]+ gnorm [\d.]+$")


def test_elastic_failover_on_4_ranks_reaches_its_step_on_1x2(tmp_path):
    outs = run_ranks(_LAUNCH, WORLD, "--arch", "yi-6b", "--device", "cpu", "--steps", "8",
                     "--batch", "4", "--seq", "16", "--model-axis", "2", "--ckpt-every", "4",
                     "--fail-at", "4:2", "--ckpt-dir", str(tmp_path), timeout=300)
    lines = outs[0].splitlines()
    assert lines[0] == "training yi-6b (0.4M params) on mesh {'data': 2, 'model': 2} from step 0"
    steps = [int(_STEP_LINE.match(l).group(1)) for l in lines[1:-1]]
    assert steps == list(range(1, 9))          # restored at 4, went on to 8
    assert lines[-1].startswith("done at step 8; final mesh {'data': 1, 'model': 2}; loss ")
    assert all(out == "" for out in outs[1:])  # rank 0 prints; the others leave quietly
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000004", "step_00000008"]


def _shape(text: str) -> list[str]:
    """Lines with their numbers blanked out (the weights differ: each
    package draws its own)."""
    return [re.sub(r"-?\d+\.\d+", "#", l) for l in text.splitlines()
            if l.startswith(("training", "  step", "done"))]


def test_launch_train_prints_the_reference_lines(tmp_path):
    args = ["--arch", "llama-300m", "--steps", "2", "--batch", "2", "--seq", "16",
            "--model-axis", "1", "--ckpt-every", "10"]
    # the reference launcher keeps an XLA_FLAGS it finds (another test in this
    # process may have set one): it gets --host-devices alone
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    ref = Process([sys.executable, "-m", "repro.launch.train", *args, "--host-devices", "1",
                   "--ckpt-dir", str(tmp_path / "ref")], env, timeout=300)
    port = Process([sys.executable, "-m", "repro_torch.launch.train", *args, "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "port")], env, timeout=300)
    got, want = _shape(port.wait()), _shape(ref.wait())
    assert got == want and len(got) == 4, (got, want)
