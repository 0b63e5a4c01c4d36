"""The codecs on the card: the hashed kd-tree's native builder
(``csrc/hashed_build.cu``) against its Python builder, the hashed decode on
CUDA tensors against the same decode on CPU tensors (flat and chunked) and
the host cut, ``build_device`` on the card against the host
``kdtree.build``, and the kd-tree's native passes (``csrc/kdtree_native.cu``:
the preorder decode, the inverse walk, the full build for any dimensions)
against their Python versions, with a failed native build raising.  Without
a CUDA device every test skips; the CPU side is
tests/test_torch_{hashed,device_build,kdtree_io,reference_impl}.py.

This file imports no JAX, so it runs on the card's machine alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_codecs_cuda.py``.
"""
import os

import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import native
from volumerenderer_tpu_torch.codecs import device_build as TDB
from volumerenderer_tpu_torch.codecs import hashed as TH
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.codecs import reference_impl as TR
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import _build

FIELDS = ("distance_map", "tree_data", "tree_structure", "coll_keys", "coll_vals", "coll_data",
          "coll_structure")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the native builder is built with nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 32, 16), (32, 32, 32)])
def test_native_builder_equals_python(cuda_device, shape):
    vol = turbulence_volume(shape, seed=5)
    tp = TH.build(vol, tolerance=4, use_native=False)
    tn = TH.build(vol, tolerance=4)   # native with a CUDA device
    tn2 = TH.build(vol, tolerance=4, use_native=True)
    for f in FIELDS:
        for t in (tn, tn2):
            a, b = getattr(t, f), getattr(tp, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert tn.tree_depth == tp.tree_depth and tn.hash_mask == tp.hash_mask


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["turbulence", "sphere"])
def test_decode_on_cuda_equals_cpu_and_host(cuda_device, kind):
    vol = turbulence_volume((32, 32, 32), seed=13) if kind == "turbulence" \
        else sphere_volume((32, 32, 32))
    tree = TH.build(vol, tolerance=4)
    dev = TH.to_device_hashed(tree, device=cuda_device)
    cpu = TH.to_device_hashed(tree, device="cpu")
    for cut in (5, tree.orig_depth, tree.tree_depth):
        host = TH.level_cut(tree, cut)
        for bits in (None, 6, 10):
            got = TH.level_cut_device_hashed(tree, dev, cut, chunk_bits=bits)
            assert got.is_cuda and got.dtype == torch.uint8
            want = TH.level_cut_device_hashed(tree, cpu, cut, chunk_bits=bits)
            assert torch.equal(got.cpu(), want)
            np.testing.assert_array_equal(got.cpu().numpy(), host)


@pytest.mark.cuda
@pytest.mark.parametrize("seed_mode", ["exact", "parallel"])
def test_build_device_on_cuda(cuda_device, seed_mode):
    vol = turbulence_volume((32, 32, 32), seed=30)
    host = TK.build(vol, tolerance=4, max_epochs=2)
    got = TDB.build_device(vol, tolerance=4, max_epochs=2, seed_mode=seed_mode,
                           device=cuda_device)
    assert got.chain_codes.is_cuda and all(c.is_cuda for c in got.level_codes)
    got = TDB.to_host(got)
    if seed_mode == "exact":
        np.testing.assert_array_equal(got.distance_map, host.distance_map)
        for a, b in zip(got.level_codes, host.level_codes):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.chain_codes, host.chain_codes)
        np.testing.assert_array_equal(got.leaf_recon, host.leaf_recon)
        assert got.num_active_nodes == host.num_active_nodes
    else:
        err_host = np.abs(TK.level_cut(host).astype(int) - vol.astype(int)).mean()
        err_dev = np.abs(TK.level_cut(got).astype(int) - vol.astype(int)).mean()
        assert err_dev <= err_host * 1.25 + 0.5, (err_dev, err_host)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 10, 12), (12, 20, 24), (5, 7, 3), (16, 16, 16)])
def test_native_build_full_equals_sequential_tree(cuda_device, shape):
    """(Z, Y, X); all but the last not powers of two."""
    vol = turbulence_volume(shape, seed=3)
    want = TR.build_arbitrary(vol, tolerance=4, max_epochs=3, use_native=False)
    for got in (TR.build_arbitrary(vol, tolerance=4, max_epochs=3),   # native with CUDA
                TR.build_arbitrary(vol, tolerance=4, max_epochs=3, use_native=True)):
        assert (got.orig_depth, got.max_depth, got.num_active_nodes) == \
            (want.orig_depth, want.max_depth, want.num_active_nodes)
        for name in ("distance_map", "preorder", "recon"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    native.kdtree_native.set_threads(1)
    try:
        one = TR.build_arbitrary(vol, tolerance=4, max_epochs=3, use_native=True)
    finally:
        native.kdtree_native.set_threads(os.cpu_count() or 1)
    np.testing.assert_array_equal(one.preorder, want.preorder)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["turbulence", "sphere", "odd"])
def test_native_walks_equal_python(cuda_device, kind):
    """The native decode at a cut below max_depth and at it, and the native
    inverse walk, against the Python walks; a truncated stream raises."""
    if kind == "odd":
        seq = TR.build_arbitrary(turbulence_volume((6, 10, 12), seed=9), 3, 2, use_native=False)
        pre, dm, dims = seq.preorder, seq.distance_map, (12, 10, 6)
        D, M = seq.orig_depth, seq.max_depth
    else:
        vol = turbulence_volume((32, 32, 32), seed=11) if kind == "turbulence" \
            else sphere_volume((32, 32, 32))
        tree = TK.build(vol, tolerance=2, max_epochs=2)
        pre, dm, dims = TK.to_preorder(tree), tree.distance_map, tree.dims
        D, M = tree.orig_depth, tree.max_depth
        levels, chains = TK.preorder_to_levels(pre, D, M)   # native with CUDA
        want_levels, want_chains = TK.preorder_to_levels(pre, D, M, use_native=False)
        for a, b, c in zip(levels, want_levels, tree.level_codes):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(chains, want_chains)
        np.testing.assert_array_equal(TR.decode_preorder(pre, dm, *dims, D, M, M),
                                      TK.level_cut(tree))
        with pytest.raises(ValueError, match="ends inside the tree"):
            TK.preorder_to_levels(pre[:len(pre) // 2], D, M, use_native=True)
    for cut in (D - 2, M):
        np.testing.assert_array_equal(TR.decode_preorder(pre, dm, *dims, D, M, cut),
                                      TR.decode_preorder(pre, dm, *dims, D, M, cut,
                                                         use_native=False))
    with pytest.raises(ValueError, match="ends inside the tree"):
        TR.decode_preorder(pre[:len(pre) // 2], dm, *dims, D, M, M, use_native=True)


@pytest.mark.cuda
def test_failed_native_build_raises(cuda_device, tmp_path, monkeypatch):
    """A native library that does not build raises in every caller: no
    Python walk stands in."""
    (tmp_path / "kdtree_native.cu").write_text("#error this library does not build\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: tmp_path / "build" / f"lib{name}-broken.so")
    monkeypatch.setattr(_build, "_loaded", {})
    native._lib.cache_clear()
    vol = turbulence_volume((6, 10, 12), seed=1)
    tree = TK.build(turbulence_volume((8, 8, 8), seed=1), tolerance=2, max_epochs=1)
    pre = TK.to_preorder(tree)
    try:
        for call in (lambda: TR.build_arbitrary(vol),
                     lambda: TK.preorder_to_levels(pre, tree.orig_depth, tree.max_depth),
                     lambda: TR.decode_preorder(pre, tree.distance_map, *tree.dims,
                                                tree.orig_depth, tree.max_depth, tree.max_depth)):
            with pytest.raises(RuntimeError, match="nvcc failed"):
                call()
    finally:
        native._lib.cache_clear()
