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
        "fused_interp.cu", "cp_async.cuh", "ieee_div.cuh"]


@pytest.mark.parametrize("header,includers", [
    ("ieee_div.cuh", {"flash_decode", "fused_interp"}),
    ("cp_async.cuh", {"flash_decode", "fused_interp"}),
    ("warp_tree.cuh", {"flash_decode", "wkv6"}),
    ("tensor_core.cuh", {"flash_attention", "flash_attention_bwd"}),
])
def test_editing_a_shared_header_renames_exactly_its_includers(
        csrc, header, includers):
    before = {name: build._target(name)[0] for name in build.SOURCES}
    _edit(csrc / header)
    renamed = {name for name in build.SOURCES
               if build._target(name)[0] != before[name]}
    assert renamed == includers


def test_probes_build_apart_from_the_kernels(tmp_path, monkeypatch):
    """A probe of the card sits in probes/, is named like a kernel's
    library, and is left out of a default build."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert set(build.PROBES).isdisjoint(build.SOURCES)
    for name in build.PROBES:
        assert build.sources(name) == [build._PROBES / f"{name}.cu"]
        so, flags = build._target(name)
        assert so.parent == tmp_path and so.name.startswith(f"{name}-")
        assert "-fmad=false" not in flags
    # everything already "built": a default build names the kernels only
    for name in build.SOURCES:
        build._target(name)[0].touch()
    assert set(build.build_all()) == set(build.SOURCES)
