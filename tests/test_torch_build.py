"""The kernel build's cache key: a library is reused only while its source,
every shared header of ``csrc/`` and the compiler flags are unchanged.  Needs
no ``nvcc``: it computes where a build would go and builds nothing."""
import shutil

import pytest

from volumerenderer_tpu_torch.ops.cuda import _build

KERNELS = ("composite_march", "iso_march", "iso_shade")


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, dst)
    return dst


def test_every_kernel_includes_the_shared_sampler():
    for name in KERNELS:
        assert '#include "trilinear.cuh"' in (_build.CSRC_DIR / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", KERNELS)
def test_header_edit_changes_library_path(csrc_copy, tmp_path, name):
    build = tmp_path / "build"
    before = _build.library_path(name, csrc_copy, build)
    assert before == _build.library_path(name, csrc_copy, build)  # stable
    header = csrc_copy / "trilinear.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = _build.library_path(name, csrc_copy, build)
    assert after != before and after.parent == build
    assert after.name.startswith(f"lib{name}-") and after.suffix == ".so"


def test_new_header_changes_library_path(csrc_copy, tmp_path):
    before = _build.library_path("iso_march", csrc_copy, tmp_path)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("iso_march", csrc_copy, tmp_path) != before


def test_source_edit_changes_only_its_own_library(csrc_copy, tmp_path):
    paths = {n: _build.library_path(n, csrc_copy, tmp_path) for n in KERNELS}
    src = csrc_copy / "iso_shade.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build.library_path("iso_shade", csrc_copy, tmp_path) != paths["iso_shade"]
    for name in ("composite_march", "iso_march"):
        assert _build.library_path(name, csrc_copy, tmp_path) == paths[name]


def test_flags_change_library_path(csrc_copy, tmp_path, monkeypatch):
    before = _build.library_path("composite_march", csrc_copy, tmp_path)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("composite_march", csrc_copy, tmp_path) != before
