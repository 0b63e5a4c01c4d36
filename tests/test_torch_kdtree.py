"""The port's host kd-tree codec against the JAX package's.

Same volumes (made by the two packages' identical synthetic generators), same
tolerances: every array of the built trees and every host level cut must be
equal.  The Δ seeding runs in the Python loop here (no CUDA device); the
compiled helper is held against it on the card
(tests/test_torch_pooled_kernel.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from volumerenderer_tpu.codecs import kdtree as JK
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.interop import kdtree_from_numpy
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume

VOLUMES = {"turbulence_32x32x64": lambda: turbulence_volume((32, 32, 64), seed=0),
           "sphere_16x16x256": lambda: sphere_volume((16, 16, 256))}


@pytest.fixture(scope="module")
def trees():
    """(volume, JAX tree, port tree) per (volume, tolerance), built once."""
    out = {}
    for name, make in VOLUMES.items():
        vol = make()
        for tol in (1, 4):
            out[name, tol] = (vol, JK.build(vol, tolerance=tol, max_epochs=2),
                              TK.build(vol, tolerance=tol, max_epochs=2))
    return out


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 1), (4096, 2), (20000, 3)])
def test_seed_level_py_matches_jax(n, seed):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 256, n, dtype=np.uint8)
    parent = np.clip(truth.astype(np.int32) + rng.integers(-40, 41, n), 0, 255).astype(np.int32)
    got = TK._seed_level_py(truth, parent)
    assert got == JK._seed_level_py(truth, parent)
    assert got[1] > 0


@pytest.mark.parametrize("tol", [1, 4])
@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_build_matches_jax(trees, name, tol):
    vol, tj, tt = trees[name, tol]
    assert tt.dims == tj.dims and tt.orig_depth == tj.orig_depth
    assert tt.max_depth == tj.max_depth and tt.schedule == tj.schedule
    np.testing.assert_array_equal(tt.distance_map, tj.distance_map)
    assert len(tt.level_codes) == len(tj.level_codes)
    for a, b in zip(tt.level_codes, tj.level_codes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tt.chain_codes, tj.chain_codes)
    np.testing.assert_array_equal(tt.leaf_recon, tj.leaf_recon)
    assert tt.num_active_nodes == tj.num_active_nodes > 0
    # the grown chains bring every leaf within tolerance
    decoded = TK.level_cut(tt)
    assert TK.measure_max_error(decoded, vol) <= tol
    assert TK.measure_mean_error(decoded, vol) == JK.measure_mean_error(decoded, vol)


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_host_level_cut_matches_jax_at_every_depth(trees, name):
    _, tj, tt = trees[name, 4]
    for cut in range(tt.max_depth + 1):
        np.testing.assert_array_equal(TK.level_cut(tt, cut), JK.level_cut(tj, cut))


def test_kdtree_from_numpy_carries_a_jax_tree(trees):
    _, tj, tt = trees["turbulence_32x32x64", 1]
    carried = kdtree_from_numpy(**dataclasses.asdict(tj))
    assert isinstance(carried, TK.KdTree)
    for cut in (0, tj.orig_depth, tj.max_depth):
        np.testing.assert_array_equal(TK.level_cut(carried, cut), JK.level_cut(tj, cut))
    np.testing.assert_array_equal(carried.chain_codes, tt.chain_codes)
    with pytest.raises(TypeError, match="fields"):
        kdtree_from_numpy(dims=(2, 2, 2))


def test_leaf_order_round_trip():
    vol = turbulence_volume((4, 8, 16), seed=5)
    sched = TK.split_schedule(16, 8, 4)
    assert sched == JK.split_schedule(16, 8, 4)
    leaves = TK.volume_to_leaves(vol, sched)
    np.testing.assert_array_equal(leaves, JK.volume_to_leaves(vol, sched))
    np.testing.assert_array_equal(TK.leaves_to_volume(leaves, (16, 8, 4), sched), vol)


def test_split_schedule_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        TK.split_schedule(12, 8, 8)


def test_seed_level_is_chosen_by_the_machine(monkeypatch):
    """With a CUDA device the compiled helper seeds and a failed build
    raises; without one the Python loop seeds."""
    truth = np.arange(64, dtype=np.uint8) * 3
    parent = np.full(64, 100, dtype=np.int32)
    want = JK.seed_level(truth, parent)

    def broken(*_):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(TK, "_seed_level_native", broken)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TK.seed_level(truth, parent) == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        TK.seed_level(truth, parent)
