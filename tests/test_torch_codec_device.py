"""The port's device tree and level-cut decode against the JAX package's.

The tree is built by the JAX package and carried over with
``interop.kdtree_from_numpy``, so both decoders read the same codes.  The
decodes (flat, and chunked with the chunk size forced small and the chunks
taken in several groups) must equal JAX's ``level_cut_device`` and the host
``level_cut`` byte for byte, and ``tree_occupancy_mip8`` must equal JAX's
and ``block_max8`` of the cut."""
import dataclasses

import numpy as np
import pytest
import torch

from volumerenderer_tpu.codecs import device as JD
from volumerenderer_tpu.codecs import kdtree as JK
from volumerenderer_tpu.ops.pallas import raycast_kernel as JR
from volumerenderer_tpu.ops.sampling import as_normalized_volume as jax_normalized
from volumerenderer_tpu_torch.codecs import device as TD
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.interop import kdtree_from_numpy
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import block_max8


@pytest.fixture(scope="module")
def turbulence_trees():
    vol = turbulence_volume((32, 32, 64), seed=0)
    tj = JK.build(vol, tolerance=1, max_epochs=2)
    return tj, kdtree_from_numpy(**dataclasses.asdict(tj))


@pytest.fixture(scope="module")
def jax_device_cuts(turbulence_trees):
    """JAX's device decode at the full depth, chains included (each cut
    depth compiles anew, ~20 s here); every depth is also held against the
    host ``level_cut``, which equals JAX's (tests/test_torch_kdtree.py)."""
    tj, _ = turbulence_trees
    dj, sj = JD.to_device(tj)
    return {tj.max_depth: np.asarray(JD.level_cut_device(dj, sj, tj.max_depth))}


def _occupancy_volume():
    """tests/test_occupancy.py's non-cubic scene."""
    rng = np.random.default_rng(21)
    v = np.zeros((16, 32, 8), np.uint8)
    v[4:10, 8:20, 2:6] = rng.integers(50, 255, size=(6, 12, 4), dtype=np.uint8)
    return v


def test_to_device_matches_jax(turbulence_trees):
    tj, tt = turbulence_trees
    dj, sj = JD.to_device(tj)
    dt, st = TD.to_device(tt, device="cpu")
    assert st == sj
    assert len(dt.packed_levels) == len(dj.packed_levels)
    for a, b in zip(dt.packed_levels, dj.packed_levels):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(dt.packed_chains.numpy(), np.asarray(dj.packed_chains))
    assert dt.distance_map.dtype == torch.int32
    np.testing.assert_array_equal(dt.distance_map.numpy(), np.asarray(dj.distance_map))


@pytest.mark.parametrize("decode", ["flat", "chunked", "chunked_groups"])
def test_level_cut_device_matches_jax_and_host(turbulence_trees, jax_device_cuts, decode,
                                              monkeypatch):
    _, tt = turbulence_trees
    dt, st = TD.to_device(tt, device="cpu")
    chunk_bits = None if decode == "flat" else 7
    if decode == "chunked_groups":  # groups of 4 chunks, so several groups
        monkeypatch.setattr(TD, "CHUNK_GROUP_LEAF_BITS", 9)
    D = tt.orig_depth
    for cut in (0, 3, D - 1, D, D + 1, D + 4, tt.max_depth):
        got = TD.level_cut_device(dt, st, cut, chunk_bits=chunk_bits)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (32, 32, 64)
        np.testing.assert_array_equal(got.numpy(), TK.level_cut(tt, cut))
        if cut in jax_device_cuts:
            np.testing.assert_array_equal(got.numpy(), jax_device_cuts[cut])


def test_deep_trees_decode_chunked(turbulence_trees, monkeypatch):
    """Past CHUNKED_DECODE_MIN_DEPTH the default decode is the chunked one."""
    _, tt = turbulence_trees
    dt, st = TD.to_device(tt, device="cpu")
    calls = []
    chunked = TD._level_cut_chunked_impl
    monkeypatch.setattr(TD, "_level_cut_chunked_impl",
                        lambda *a: calls.append(a[-1]) or chunked(*a))
    monkeypatch.setattr(TD, "CHUNKED_DECODE_MIN_DEPTH", tt.orig_depth)
    monkeypatch.setattr(TD, "CHUNK_LEAF_BITS", 10)
    got = TD.level_cut_device(dt, st)
    assert calls == [tt.orig_depth - 10]
    np.testing.assert_array_equal(got.numpy(), TK.level_cut(tt))


@pytest.mark.parametrize("regime", ["tree_scalars", "chunked_cut"])
def test_tree_occupancy_mip8_matches_jax_and_block_max(regime, monkeypatch):
    v = _occupancy_volume()
    tj = JK.build(v, tolerance=2, max_epochs=2)
    tt = kdtree_from_numpy(**dataclasses.asdict(tj))
    dj, sj = JD.to_device(tj)
    dt, st = TD.to_device(tt, device="cpu")
    if regime == "chunked_cut":
        monkeypatch.setattr(TD, "CHUNKED_DECODE_MIN_DEPTH", tt.orig_depth)
        monkeypatch.setattr(TD, "CHUNK_LEAF_BITS", 6)
    for cut in (st["orig_depth"] // 2, st["orig_depth"], st["max_depth"]):
        got = TD.tree_occupancy_mip8(dt, st, cut)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, 1)
        want = np.asarray(JD.tree_occupancy_mip8(dj, sj, cut))
        np.testing.assert_array_equal(got.numpy(), want)
        cut_u8 = TD.level_cut_device(dt, st, cut)
        np.testing.assert_array_equal(got.numpy(), block_max8(cut_u8).numpy())
        np.testing.assert_array_equal(
            want, np.asarray(JR.block_max8(jax_normalized(cut_u8.numpy()))))
