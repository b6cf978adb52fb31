"""The port's kernel build: which library name a source maps to.

``ops/_build.library_path`` names each library by a hash of its source,
the headers under ``csrc/`` and the nvcc flags, so that a changed file
builds anew and an unchanged one is reused.  These cases run on a
private ``csrc/`` and build directory; no ``nvcc`` is needed.
"""

import pytest

from mpi_tensorflow_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (src / "b.cu").write_text("int b;\n")
    (src / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "SOURCES", {"a": "a.cu", "b": "b.cu"})
    return src


def test_library_path_is_stable_and_inside_the_build_dir(csrc):
    path = _build.library_path("a")
    assert path == _build.library_path("a")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("liba_") and path.suffix == ".so"
    assert path != _build.library_path("b")


@pytest.mark.parametrize("edit", ["source", "header", "new header"])
def test_library_path_changes_with_what_the_build_reads(csrc, edit):
    before = _build.library_path("a")
    if edit == "source":
        (csrc / "a.cu").write_text("int a2;\n")
    elif edit == "header":
        (csrc / "common.cuh").write_text("#pragma once\n#define X 1\n")
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("a") != before


def test_library_path_ignores_files_that_are_not_headers(csrc):
    before = _build.library_path("a")
    (csrc / "notes.txt").write_text("not compiled\n")
    assert _build.library_path("a") == before


def test_library_path_changes_with_the_flags(csrc, monkeypatch):
    before = _build.library_path("a")
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-G"))
    assert _build.library_path("a") != before


def test_flags_target_hopper_with_its_arch_specific_features():
    # wgmma exists only for sm_90a, not for plain sm_90
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags


def test_every_source_exists():
    for name, src in _build.SOURCES.items():
        assert (_build.CSRC / src).is_file(), name
