"""The kernel builder's library names: a hash of the source, of every
local header it includes, and of the flags (kernels/build.py).

Runs on the CPU: it computes names and never calls nvcc.
"""

import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that the builder reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build._CSRC, copy)
    monkeypatch.setattr(build, "_CSRC", copy)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "libs"))
    return copy


def _edit(path, text="\n// edited\n"):
    path.write_text(path.read_text() + text)


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_library_name_changes_with_the_shared_header(csrc, name):
    before, _ = build._target(name)
    assert csrc / "tensor_core.cuh" in build.sources(name)
    _edit(csrc / "tensor_core.cuh")
    after, _ = build._target(name)
    assert after != before
    assert after.parent == before.parent == csrc.parent / "libs"


@pytest.mark.parametrize("name", ["pairwise_sqdist", "flash_decode"])
def test_library_name_ignores_headers_a_source_does_not_include(csrc, name):
    before, _ = build._target(name)
    _edit(csrc / "tensor_core.cuh")
    assert build._target(name)[0] == before


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_library_name_changes_with_the_source(csrc, name):
    before, _ = build._target(name)
    assert build._target(name)[0] == before      # stable while unedited
    _edit(csrc / f"{name}.cu")
    assert build._target(name)[0] != before


def test_headers_are_followed_through_headers(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    _edit(csrc / "tensor_core.cuh", '\n#include "inner.cuh"\n')
    assert [p.name for p in build.sources("flash_attention")] == [
        "flash_attention.cu", "tensor_core.cuh", "inner.cuh"]
    before, _ = build._target("flash_attention")
    _edit(csrc / "inner.cuh")
    assert build._target("flash_attention")[0] != before


def test_system_headers_and_missing_files_are_not_followed(csrc):
    _edit(csrc / "fused_interp.cu",
          '\n#include <cuda_runtime.h>\n#include "not_here.cuh"\n')
    assert [p.name for p in build.sources("fused_interp")] == [
        "fused_interp.cu"]
