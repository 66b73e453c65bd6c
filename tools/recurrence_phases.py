#!/usr/bin/env python3
"""Where a recurrence kernel's time goes, phase by phase, on the card.

    python3 tools/recurrence_phases.py        # from the root of a checkout; one card

Copies csrc/ into build/repro_torch/phase-clocks/ and builds
csrc/rwkv6_wkv.cu and csrc/mamba2_ssd.cu from the copy with a probe patched
in (the sources themselves carry none): at the lines MARKS names, the first
thread of block (0, 0) adds the clock64() ticks since its previous mark to
one slot of a device array, which the library exports. Runs each bf16
kernel once at the recurrent path's prefill shape (rwkv6-7b: 4 x 451
tokens, 64 heads of N 64; zamba2-2.7b: 80 heads of P 64, N 64) and prints
the ticks a phase per chunk. They are SM clocks of one block, which shares
its SM with the other blocks there: a profile of where one block waits,
not a device time. Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PHASES = {
    "rwkv6_wkv": {1: "prep (decays, splits, bonus) + barrier",
                  2: "publish e^(m/2) S, score parts + barrier", 3: "y: a_in . S + scores . v",
                  4: "state update", 5: "wait for chunk c + 1 + barrier",
                  6: "issue the loads of chunk c + 2", 0: "loop top"},
    "mamba2_ssd": {1: "publish S, scan, x e^(m - cum) dt split + barrier",
                   3: "y: e^cum C . S + scores . x", 4: "state update",
                   5: "wait for chunk c + 1 + barrier", 6: "issue the loads of chunk c + 2",
                   0: "loop top"},
}
# where the probe goes: (the start of a source line, which must be the only
# line that starts so; 0 to insert before it, 1 after it, 2 after the line
# after it; the statement inserted, at the line's indentation)
_LOOP_END = [("cp_async_wait<0>();", 0, "PHASE_MARK(4);"),
             ("if (c + 2 < nchunks) load_chunk(c + 2, st);", 0, "PHASE_MARK(5);"),
             ("if (c + 2 < nchunks) load_chunk(c + 2, st);", 2, "PHASE_MARK(6);")]
MARKS = {
    "rwkv6_wkv": [("const int nchunks = (T_ + L - 1) / L;", 1, "PHASE_START();"),
                  ("auto& in = sm.stage[st];", 1, "PHASE_MARK(0);"),
                  ("// publish e^half S; the warp's part", 0, "PHASE_MARK(1);"),
                  ("// y (16 rows x the warp's 16 columns)", 0, "PHASE_MARK(2);"),
                  ("// S <- e^half (e^half S + b_in^T v)", 0, "PHASE_MARK(3);")] + _LOOP_END,
    "mamba2_ssd": [("const int nchunks = (T_ + LC - 1) / LC;", 1, "PHASE_START();"),
                   ("publish();                             // the state before chunk c", 0,
                    "PHASE_MARK(0);"),
                   ("// y: rows i = 16 ym + g (+ 8)", 0, "PHASE_MARK(1);"),
                   ("// S <- e^m S + B^T (x e^(m - cum) dt)", 0, "PHASE_MARK(3);")] + _LOOP_END,
}
PROBE = r"""
__device__ unsigned long long rt_phase_clocks[8];
extern "C" int rt_phase_clocks_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, rt_phase_clocks, sizeof(rt_phase_clocks));
}
extern "C" int rt_phase_clocks_zero() {
  unsigned long long z[8] = {};
  return (int)cudaMemcpyToSymbol(rt_phase_clocks, z, sizeof(z));
}
#define PHASE_START() long long rt_t_last = clock64()
#define PHASE_MARK(k)                                                            \
  do {                                                                           \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {                \
      const long long rt_now = clock64();                                        \
      atomicAdd(&rt_phase_clocks[k], (unsigned long long)(rt_now - rt_t_last)); \
      rt_t_last = rt_now;                                                        \
    }                                                                            \
  } while (0)
"""


def patched(text: str, marks) -> str:
    """The source with the probe's definitions after its includes and its
    marks inserted; raises where a mark's line is missing or not unique."""
    lines = text.split("\n")
    inserts = []
    for start, offset, stmt in marks:
        at = [i for i, ln in enumerate(lines) if ln.strip().startswith(start)]
        if len(at) != 1:
            raise SystemExit(f"{len(at)} lines start with {start!r}; the probe needs one")
        indent = lines[at[0]][:len(lines[at[0]]) - len(lines[at[0]].lstrip())]
        inserts.append((at[0] + offset, indent + stmt))
    for i, ln in sorted(inserts, key=lambda x: -x[0]):
        lines.insert(i, ln)
    last_include = max(i for i, ln in enumerate(lines) if ln.startswith("#include"))
    lines.insert(last_include + 1, PROBE)
    return "\n".join(lines)


def main() -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    work = build.BUILD_DIR / "phase-clocks"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(build.CSRC, work)
    libs = {}
    procs = []
    for src in PHASES:
        cu = work / f"{src}.cu"
        cu.write_text(patched(cu.read_text(), MARKS[src]))
        out = work / f"lib{src}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(work), "-o", str(out), str(cu)]
        procs.append((src, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    for src, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {src}:\n{log}")
        libs[src] = ctypes.CDLL(str(out))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    b, t = 4, 451
    stream = torch.cuda.current_stream().cuda_stream
    h, n = 64, 64
    r, k, v = ((rand(b, t, h, n) * 0.5).bfloat16() for _ in range(3))
    logw = (-torch.exp(rand(b, t, h, n) * 0.5)).clamp(-8.0, -1e-4)
    u, s0 = rand(h, n) * 0.1, rand(b, h, n, n) * 0.1
    y, st = torch.empty(b, t, h, n, device="cuda"), torch.empty(b, h, n, n, device="cuda")
    calls = {"rwkv6_wkv": ("rwkv6_wkv_launch", wkv.KERNEL.argtypes,
                           [a.data_ptr() for a in (r, k, v, logw, u, s0, y, st)]
                           + [b, t, h, n, 1, stream], -(-t // wkv.CHUNK))}
    h, p = 80, 64
    x = (rand(b, t, h, p) * 0.5).bfloat16()
    bm, cm = ((rand(b, t, n) * 0.5).bfloat16() for _ in range(2))
    dt, a_log = F.softplus(rand(b, t, h)), torch.log(torch.linspace(1.0, 8.0, h, device="cuda"))
    s0 = rand(b, h, n, p) * 0.1
    y2, st2 = torch.empty(b, t, h, p, device="cuda"), torch.empty(b, h, n, p, device="cuda")
    calls["mamba2_ssd"] = ("mamba2_ssd_launch", ssd.KERNEL.argtypes,
                           [a.data_ptr() for a in (x, bm, cm, dt, a_log, s0, y2, st2)]
                           + [b, t, h, n, p, 1, stream], -(-t // ssd.KERNEL_CHUNK))
    for src, (symbol, argtypes, args, chunks) in calls.items():
        lib = libs[src]
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fn(*args)                           # warm-up
        lib.rt_phase_clocks_zero()
        if fn(*args) != 0:
            raise SystemExit(f"{symbol} refused the launch")
        torch.cuda.synchronize()
        ticks = (ctypes.c_ulonglong * 8)()
        lib.rt_phase_clocks_read(ticks)
        total = sum(ticks)
        print(f"{src}: block (0, 0), {chunks} chunks, {total} clocks in all, "
              f"{total / chunks:.0f} a chunk")
        for slot, name in sorted(PHASES[src].items(), key=lambda kv: -ticks[kv[0]]):
            print(f"  {name}: {ticks[slot] / chunks:.0f} clocks a chunk "
                  f"({100 * ticks[slot] / total:.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
