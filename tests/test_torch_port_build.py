"""The port's kernel build (``ops/_build.py``) on the CPU, without nvcc.

``subprocess.run`` (nvcc) and ``ctypes.CDLL`` are replaced by fakes, so
these tests check what the build keys, runs and refuses: the library's
path follows the source, every ``csrc/`` file it includes and the flags;
CUTLASS's include path is added only for a source that includes it; no
nvcc raises.
"""

from __future__ import annotations

import os
import subprocess

import pytest

from multiple_objects_gan_tpu_torch.ops import _build


@pytest.fixture
def fake_csrc(tmp_path, monkeypatch):
    """A csrc/ of three files, k.cu -> a.cuh -> b.cuh, and an unrelated
    c.cuh; nvcc and CDLL faked. Returns (csrc, the nvcc command lines)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n'
                               'extern "C" int f() { return A + B; }\n')
    (csrc / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n'
                                "constexpr int A = 1;\n")
    (csrc / "b.cuh").write_text("#pragma once\nconstexpr int B = 2;\n")
    (csrc / "c.cuh").write_text("constexpr int C = 3;\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_built", {})
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/fake/nvcc")
    calls = []

    def run(cmd, capture_output, text):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"so")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info: 1 reg", "")

    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    return csrc, calls


def _rebuild(name="k"):
    _build._built.clear()
    return _build.build(name)


def test_sources_follow_local_includes_only(fake_csrc):
    csrc, _ = fake_csrc
    assert _build.sources("k") == [str(csrc / n)
                                   for n in ("k.cu", "a.cuh", "b.cuh")]


def test_editing_an_included_header_changes_the_library(fake_csrc):
    csrc, calls = fake_csrc
    first = _build.build("k")
    assert os.path.exists(first.path) and len(calls) == 1
    assert first.log.startswith("ptxas") and first.lib == ("lib", first.path)
    assert _rebuild().path == first.path and len(calls) == 1   # reused
    (csrc / "c.cuh").write_text("constexpr int C = 4;\n")       # not included
    assert _rebuild().path == first.path and len(calls) == 1
    (csrc / "b.cuh").write_text("#pragma once\nconstexpr int B = 5;\n")
    second = _rebuild()
    assert second.path != first.path and len(calls) == 2
    (csrc / "k.cu").write_text((csrc / "k.cu").read_text() + "// edit\n")
    assert _rebuild().path not in (first.path, second.path)
    assert calls[-1][-1] == str(csrc / "k.cu")


def test_flags_are_part_of_the_key(fake_csrc, monkeypatch):
    first = _build.build("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    second = _rebuild()
    assert second.path != first.path
    assert "-G" in fake_csrc[1][-1]


def test_cutlass_include_only_where_a_source_includes_it(fake_csrc, tmp_path,
                                                        monkeypatch):
    csrc, calls = fake_csrc
    cutlass = tmp_path / "cutlass" / "include"
    monkeypatch.setattr(_build, "CUTLASS_INCLUDE", str(cutlass))
    (csrc / "b.cuh").write_text("#pragma once\n#include <cute/tensor.hpp>\n")
    _build.build("k")
    assert "-I" not in calls[-1]              # the folder does not exist
    cutlass.mkdir(parents=True)
    _rebuild()
    assert calls[-1][calls[-1].index("-I") + 1] == str(cutlass)
    (csrc / "b.cuh").write_text("#pragma once\n")
    _rebuild()
    assert "-I" not in calls[-1]


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_built", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("normconv")


def test_failed_build_raises_with_the_compiler_output(fake_csrc, monkeypatch):
    def run(cmd, capture_output, text):
        return subprocess.CompletedProcess(cmd, 2, "", "k.cu(3): error")

    monkeypatch.setattr(_build.subprocess, "run", run)
    with pytest.raises(RuntimeError, match=r"k.cu\(3\): error"):
        _build.build("k")
    assert not os.listdir(_build.BUILD_DIR)   # no library, no temp file


def test_the_port_sources_and_their_headers():
    assert [os.path.basename(p) for p in _build.sources("normconv")] == [
        "normconv.cu", "hopper.cuh"]
    assert [os.path.basename(p) for p in _build.sources("stn_place")] == [
        "stn_place.cu"]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__9adbc837_11_normconv_cu_94a1591621normconv_wgmma_kernelILi256EEEv14CUtensorMap_stPK13__nv_bfloat16PKfS6_PS2_PfS8_iiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__9adbc837_11_normconv_cu_94a1591621normconv_wgmma_kernelILi256EEEv14CUtensorMap_stPK13__nv_bfloat16PKfS6_PS2_PfS8_iiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 253 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__da3ac05c_12_stn_place_cu_10f02ae727stn_place_multi_grad_kernelIfEEvPKT_PKfPS1_iiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__da3ac05c_12_stn_place_cu_10f02ae727stn_place_multi_grad_kernelIfEEvPKT_PKfPS1_iiiiiiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 62 registers, used 1 barriers, 256 bytes smem
"""


def test_chip_smoke_reads_one_ptxas_line_a_kernel():
    import chip_smoke

    lines = chip_smoke.ptxas_lines(PTXAS_LOG)
    assert lines == [
        "normconv_wgmma_kernelILi256E: used 253 registers, used 1 barriers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "stn_place_multi_grad_kernelIf: used 62 registers, used 1 barriers, "
        "256 bytes smem; 8 bytes stack frame, 4 bytes spill stores, 4 bytes "
        "spill loads"]
    assert chip_smoke.ptxas_lines("") == []
