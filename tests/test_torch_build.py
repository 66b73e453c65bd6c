"""The spill gates read a ptxas log saved beside every library, built now or
cached. No card or nvcc is needed: nvcc and cuobjdump are replaced by fakes
that write a library file and print a `-Xptxas=-v` log or a SASS listing.
"""
import pathlib
import subprocess
import sys

import pytest

from repro_torch.kernels import build

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

NO_SPILL = "0 bytes spill stores, 0 bytes spill loads"
SPILL = "12 bytes spill stores, 12 bytes spill loads"
BF16 = "13__nv_bfloat16"


def _entry(kernel: str, targs: str, spills: str = NO_SPILL) -> str:
    """One entry function of a ptxas -v log, named as nvcc mangles a kernel
    template in an anonymous namespace."""
    return (f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{len(kernel)}"
            f"{kernel}I{targs}EEvPKT_' for 'sm_90a'\n"
            f"ptxas info    : Function properties for kernel\n"
            f"    0 bytes stack frame, {spills}\n"
            f"ptxas info    : Used 96 registers, used 1 barriers\n")


def _clean_logs() -> dict:
    """A log per source holding the instantiations the gates look for."""
    return {
        "flash_attention": _entry("flash_mma_kernel", "Li128E"),
        "paged_prefill_attention": _entry("paged_prefill_mma_kernel", "Li128E"),
        "decode_attention": _entry("decode_kernel", f"{BF16}Li128ELi1E")
        + _entry("decode_kernel", f"{BF16}Li80ELi1E")
        + _entry("decode_kernel", f"{BF16}Li128ELi8E")
        + _entry("decode_kernel", f"{BF16}Li64ELi1E"),
        "paged_decode_attention": _entry("paged_decode_kernel", f"{BF16}Li128ELi1E")
        + _entry("paged_decode_kernel", f"{BF16}Li80ELi1E"),
        "rwkv6_wkv": _entry("wkv_mma_kernel", "Li64E"),
        "mamba2_ssd": _entry("ssd_mma_kernel", "Li64ELi64ELi64E"),
    }


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """build_all into tmp_path with a fake nvcc; returns (logs it prints
    per source, the sources it was started for)."""
    logs, started = _clean_logs(), []

    class FakeNvcc:
        def __init__(self, cmd, **kwargs):
            self.source = pathlib.Path(cmd[-1]).stem
            started.append(self.source)
            self.out = pathlib.Path(cmd[cmd.index("-o") + 1])
            self.returncode = None

        def communicate(self):
            fail = logs[self.source] is None
            self.returncode = 1 if fail else 0
            if fail:
                return "error: nvcc refused it\n", None
            self.out.write_bytes(b"\x7fELF fake library")
            return logs[self.source], None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    return logs, started


def test_build_all_saves_a_ptxas_log_beside_each_library(fake_nvcc, tmp_path):
    logs, started = fake_nvcc
    got = build.build_all()
    assert sorted(got) == sorted(build.SOURCES) == sorted(started)
    for src in build.SOURCES:
        lib = build._lib_path(src)
        saved = tmp_path / (lib.name[:-len(".so")] + ".ptxas.txt")
        assert lib.exists() and saved.exists()
        assert saved.name.startswith(f"lib{src}-")
        assert saved.read_text() == got[src] == logs[src] == build.ptxas_log(src)
    assert sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".tmp") == []
    # a second build finds every library cached and starts no nvcc; the
    # logs are still read from disk
    started.clear()
    assert build.build_all() == {} and started == []
    assert all(build.ptxas_log(src) == logs[src] for src in build.SOURCES)


def test_a_failed_build_leaves_neither_library_nor_log(fake_nvcc, tmp_path):
    logs, _ = fake_nvcc
    logs["rwkv6_wkv"] = None
    with pytest.raises(RuntimeError, match="nvcc failed for rwkv6_wkv.cu"):
        build.build_all()
    assert not build._lib_path("rwkv6_wkv").exists()
    assert not list(tmp_path.glob("librwkv6_wkv-*"))
    assert build.ptxas_log("mamba2_ssd") == logs["mamba2_ssd"]


def test_phase_build_reads_the_logs_of_cached_libraries(fake_nvcc):
    logs, started = fake_nvcc
    assert chip_smoke.phase_build() == logs
    started.clear()
    assert chip_smoke.phase_build() == logs and started == []


def test_phase_build_fails_on_a_cached_library_without_its_log(fake_nvcc):
    build.build_all()
    lib = build._lib_path("decode_attention")
    lib.with_suffix(".ptxas.txt").unlink()
    with pytest.raises(RuntimeError, match="delete it and rebuild"):
        chip_smoke.phase_build()


def test_a_spilling_library_fails_the_gates_again_when_cached(fake_nvcc, monkeypatch):
    logs, started = fake_nvcc
    logs["flash_attention"] = _entry("flash_mma_kernel", "Li128E", SPILL)
    logs["paged_decode_attention"] = _entry("paged_decode_kernel", f"{BF16}Li128ELi1E", SPILL) \
        + _entry("paged_decode_kernel", f"{BF16}Li80ELi1E")
    logs["mamba2_ssd"] += _entry("ssd_mma_kernel", "Li128ELi128ELi32E", SPILL)

    class Sass:
        stdout = "  /*0010*/ HMMA.16816.F32.BF16 R0, R4, R8, R0 ;\n" \
                 "  /*0020*/ LDGSTS.E.BYPASS.128 [R2], desc[UR4][R6.64] ;\n"

    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: Sass)
    for run in range(2):                  # built in the first run, cached in the second
        with pytest.raises(RuntimeError, match="spills at head_dim 128"):
            chip_smoke.phase_build()
        assert started == list(build.SOURCES) if run == 0 else started == []
        started.clear()
        cached = {src: build.ptxas_log(src) for src in build.SOURCES}
        with pytest.raises(RuntimeError, match=r"paged_decode_kernel<bf16,128,1> spills"):
            chip_smoke.phase_sass(cached)
        cached["paged_decode_attention"] = _clean_logs()["paged_decode_attention"]
        with pytest.raises(RuntimeError, match=r"ssd_mma_kernel<128,128,32>"):
            chip_smoke.phase_sass(cached)
        cached["mamba2_ssd"] = _clean_logs()["mamba2_ssd"]
        chip_smoke.phase_sass(cached)     # clean logs pass every gate
