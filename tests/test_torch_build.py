"""The build of the port's CUDA libraries keys each library on its sources
and on the headers they include, so that an edit to a shared header
(``csrc/hopper.cuh``) builds anew instead of loading a stale library.  No
nvcc is needed: the digest is computed over a temporary source tree."""

import pytest

from heat_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "kernel.cu").write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\nint f() { return g(); }\n')
    (tmp_path / "shared.cuh").write_text('#pragma once\n#include "inner.cuh"\ninline int g() { return h(); }\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\ninline int h() { return 1; }\n")
    (tmp_path / "unused.cuh").write_text("#pragma once\n")
    return tmp_path


@pytest.mark.parametrize("header", ["shared.cuh", "inner.cuh"])
def test_an_included_header_changes_the_digest(csrc, header):
    before = _build._digest([csrc / "kernel.cu"])
    assert _build._digest([csrc / "kernel.cu"]) == before
    (csrc / header).write_text((csrc / header).read_text() + "// edited\n")
    assert _build._digest([csrc / "kernel.cu"]) != before


def test_a_header_not_included_leaves_the_digest(csrc):
    before = _build._digest([csrc / "kernel.cu"])
    (csrc / "unused.cuh").write_text("#pragma once\n// edited\n")
    assert _build._digest([csrc / "kernel.cu"]) == before


def test_headers_are_hashed_but_not_compiled(csrc):
    # the header list is for the hash only: nvcc gets the sources
    found = _build._with_headers([csrc / "kernel.cu"])
    assert [p.name for p in found] == ["kernel.cu", "shared.cuh", "inner.cuh"]


def test_the_port_sources_include_the_shared_header():
    found = {p.name for p in _build._with_headers([_build.CSRC / "attention.cu", _build.CSRC / "matmul.cu"])}
    assert "hopper.cuh" in found
