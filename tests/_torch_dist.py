"""Run a script as the ranks of a CPU process group (gloo), for the port's
multi-process tests: one `python -c` subprocess a rank, with RANK,
WORLD_SIZE, LOCAL_RANK and a free localhost MASTER_PORT in its environment
(what torchrun would set), so the script calls
`dist.init_process_group("gloo")`. Each rank runs with one thread. A run
whose rendezvous lost its port to another process is started once more. It
holds no tests of its own."""
import os
import re
import socket
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# a rendezvous that lost its port to another process between free_port()
# and rank 0's bind (tests run side by side under xdist): started again once
_PORT_RACE = re.compile(r"EADDRINUSE|Address already in use|DistNetworkError")


class Ranks:
    """The ranks of one run, started; `wait` collects them."""

    def __init__(self, script: str, world: int, args, timeout: int):
        self.script, self.world, self.args, self.timeout = script, world, args, timeout
        self._start()

    def _start(self) -> None:
        port = free_port()
        self.procs = []
        for rank in range(self.world):
            env = dict(os.environ, PYTHONPATH=SRC, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(self.world), OMP_NUM_THREADS="1")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(self.script), *self.args], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def _collect(self) -> list:
        outs = []
        try:
            for p in self.procs:
                out, err = p.communicate(timeout=self.timeout)
                outs.append((p.returncode, out, err))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return outs

    def wait(self) -> list[str]:
        """Every rank's stdout; fails if any rank fails or the run outlasts
        its timeout (then every rank is killed)."""
        outs = self._collect()
        if any(rc != 0 and _PORT_RACE.search(err) for rc, _, err in outs):
            self._start()
            outs = self._collect()
        for rank, (rc, out, err) in enumerate(outs):
            assert rc == 0, f"rank {rank} rc={rc}\nstdout={out}\nstderr={err[-4000:]}"
        return [out for _, out, _ in outs]


def start_ranks(script: str, world: int, *args: str, timeout: int = 300) -> Ranks:
    return Ranks(script, world, args, timeout)


def run_ranks(script: str, world: int, *args: str, timeout: int = 300) -> list[str]:
    """Every rank's stdout (see Ranks.wait)."""
    return start_ranks(script, world, *args, timeout=timeout).wait()


class Process:
    """One subprocess, started; `wait` returns its stdout or fails."""

    def __init__(self, argv: list[str], env: dict, timeout: int):
        self.timeout = timeout
        self.proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    def wait(self) -> str:
        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        assert self.proc.returncode == 0, f"stdout={out}\nstderr={err[-4000:]}"
        return out
