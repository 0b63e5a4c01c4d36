"""The port's device-side kd-tree build (``codecs/device_build.py``) against
the port's host build (``codecs/kdtree.py``) and the JAX package's
``build_device`` (``volumerenderer_tpu/codecs/device_build.py``), on CPU
tensors.

``seed_mode="exact"`` equals both array for array (distance map, level
codes, chains, leaf recon, active count) on 16^3 turbulence and sphere and a
non-cubic volume.  ``seed_mode="parallel"``'s raw float32 seed is within
1e-5 relative of JAX's (the two reduce in different orders), and its tree
reconstructs as well as the host build's (tests/test_device_build.py:19).
The card's side is tests/test_torch_codecs_cuda.py."""
import numpy as np
import pytest
import torch

from volumerenderer_tpu.codecs import device_build as JDB
from volumerenderer_tpu_torch.codecs import device_build as TDB
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume

VOLUMES = {
    "turbulence_16": lambda: turbulence_volume((16, 16, 16), seed=30),
    "sphere_16": lambda: sphere_volume((16, 16, 16)),
    "turbulence_8x32x16": lambda: turbulence_volume((8, 32, 16), seed=3),
}


def _assert_same(t, w):
    t = TDB.to_host(t)  # build_device's tree keeps its arrays on its device
    np.testing.assert_array_equal(t.distance_map, np.asarray(w.distance_map))
    assert len(t.level_codes) == len(w.level_codes)
    for a, b in zip(t.level_codes, w.level_codes):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, np.asarray(b))
    assert t.chain_codes.dtype == np.uint8
    np.testing.assert_array_equal(t.chain_codes, np.asarray(w.chain_codes))
    np.testing.assert_array_equal(t.leaf_recon, np.asarray(w.leaf_recon))
    np.testing.assert_array_equal(t.leaf_truth, np.asarray(w.leaf_truth))
    assert t.num_active_nodes == w.num_active_nodes
    assert (t.dims, t.orig_depth, t.max_depth, list(t.schedule)) == \
        (tuple(w.dims), w.orig_depth, w.max_depth, list(w.schedule))


@pytest.mark.parametrize("name", list(VOLUMES))
def test_exact_seed_equals_host_build_and_jax(name):
    vol = VOLUMES[name]()
    got = TDB.build_device(vol, tolerance=2, max_epochs=2, seed_mode="exact", device="cpu")
    _assert_same(got, TK.build(vol, tolerance=2, max_epochs=2))
    _assert_same(got, JDB.build_device(vol, tolerance=2, max_epochs=2, seed_mode="exact"))
    np.testing.assert_array_equal(TK.level_cut(TDB.to_host(got)),
                                  TK.level_cut(TK.build(vol, tolerance=2, max_epochs=2)))


def test_exact_seed_takes_a_tensor_and_refuses_other_dtypes():
    vol = VOLUMES["sphere_16"]()
    got = TDB.build_device(torch.from_numpy(vol), tolerance=4, max_epochs=2, device="cpu")
    _assert_same(got, TK.build(vol, tolerance=4, max_epochs=2))
    with pytest.raises(ValueError, match="uint8"):
        TDB.build_device(torch.zeros((4, 4, 4)), device="cpu")
    with pytest.raises(ValueError, match="seed_mode"):
        TDB.build_device(vol, seed_mode="other", device="cpu")


@pytest.mark.parametrize("n,seed", [(1, 0), (4096, 1), (65536, 2)])
def test_parallel_seed_within_1e5_of_jax(n, seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 256, n).astype(np.uint8)
    parent = np.clip(truth.astype(np.int32) + rng.integers(-40, 41, n), 0, 255).astype(np.int32)
    got = float(TDB._seed_parallel(torch.from_numpy(truth), torch.from_numpy(parent)))
    want = float(JDB._seed_parallel(jnp.asarray(truth), jnp.asarray(parent)))
    assert abs(got - want) <= 1e-5 * max(abs(want), 1e-6), (got, want)


def test_parallel_seed_quality():
    vol = turbulence_volume((16, 16, 16), seed=31)
    host = TK.build(vol, tolerance=2, max_epochs=2)
    dev = TDB.build_device(vol, tolerance=2, max_epochs=2, seed_mode="parallel", device="cpu")
    err_host = np.abs(TK.level_cut(host).astype(int) - vol.astype(int)).mean()
    err_dev = np.abs(TK.level_cut(TDB.to_host(dev)).astype(int) - vol.astype(int)).mean()
    assert err_dev <= err_host * 1.25 + 0.5, (err_dev, err_host)
