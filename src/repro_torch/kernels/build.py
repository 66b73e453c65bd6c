"""Build and bind the hand-written CUDA kernels.

Each source `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into a shared
library of its own with a plain C interface, and loaded with `ctypes`. The
libraries go to `build/repro_torch/` at the root of the checkout, named by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads at once. Nothing is built when a module is imported:
the first launch builds its library, and `build_all()` builds every source
in parallel (one `nvcc` per source), as `chip_smoke.py` does up front.

Every launcher returns a `cudaError_t` code (the launch's
`cudaGetLastError()`); `CudaKernel.launch` raises on anything but 0 and
counts the launches it made, so a run can show that its path went through
the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v"]
SOURCES = ("flash_attention", "decode_attention", "paged_decode_attention",
           "paged_prefill_attention", "rwkv6_wkv", "mamba2_ssd")
HEAD_DIMS = (32, 64, 80, 128)
STATE_DIMS = (16, 32, 64, 128)     # N (and P) the recurrence kernels take
PTR = ctypes.c_void_p
INT = ctypes.c_int


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def _lib_path(source: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{source}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{source}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(source: str, out: pathlib.Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{source}.cu")]


def build_all(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all at once; return
    {source: compiler log} for the ones built (ptxas register/spill lines)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        lib = _lib_path(src)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (subprocess.Popen(
            _nvcc_cmd(src, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    logs, failed = {}, []
    for src, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[src] = out
        if proc.returncode != 0:
            failed.append(f"{src}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)          # atomic: a reader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


class CudaKernel:
    """One launcher of one compiled source: its C signature, its library
    (built at first use), and a plain count of the launches made."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._err = None

    def _bind(self):
        if self._fn is None:
            lib_path = _lib_path(self.source)
            if not lib_path.exists():
                build_all([self.source])
            lib = ctypes.CDLL(str(lib_path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.rt_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream; raise if the launch was refused."""
        rc = self._bind()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed: cuda error {rc} "
                               f"({self._err(rc).decode()})")
        self.launches += 1


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor `t`'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def is_bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def check(name: str, t, shape: tuple, dtype, device) -> None:
    """Raise unless `t` is a contiguous tensor of this shape, type and device."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name: str, t) -> None:
    """The kernels copy rows in 16-byte pieces (cp.async): the prefill
    kernels' and the recurrences' bf16 routes and both decodes in either
    type."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for the CUDA kernels")


def check_float(name: str, t) -> None:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: the CUDA kernels take float32 or bfloat16, "
                         f"got {t.dtype}")


def check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the CUDA kernels "
                         f"(one of {HEAD_DIMS})")


def check_state_dim(name: str, n: int) -> None:
    if n not in STATE_DIMS:
        raise ValueError(f"{name} = {n} not supported by the recurrence kernels "
                         f"(one of {STATE_DIMS})")
