"""The codecs on the card: the hashed kd-tree's native builder
(``csrc/hashed_build.cu``) against its Python builder, the hashed decode on
CUDA tensors against the same decode on CPU tensors (flat and chunked) and
the host cut, and ``build_device`` on the card against the host
``kdtree.build``.  Without a CUDA device every test skips; the CPU side is
tests/test_torch_{hashed,device_build}.py.

This file imports no JAX, so it runs on the card's machine alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_codecs_cuda.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch.codecs import device_build as TDB
from volumerenderer_tpu_torch.codecs import hashed as TH
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume

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
