"""The port's mid-range codec (``codecs/midrange.py``) against the JAX
package's (``volumerenderer_tpu/codecs/midrange.py``).

At tests/test_codec_midrange.py's sizes: 16^3 (and a 4^3 random) volumes,
tolerance 2, two epochs.  The port's ``build`` equals JAX's array for array,
its midpoint channel equals the port's ``kdtree.build``, the range decode
and ``to_device_pair``'s decode equal JAX's, a JAX tree carries across with
``interop.midrange_from_numpy``, and ``CompressedRenderer`` renders a
``MidRangeTree`` as it renders the ``KdTree`` of its midpoint channel.
"""
import dataclasses

import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, generate_rays
from volumerenderer_tpu_torch.codecs import device as TD
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.codecs import midrange as TM
from volumerenderer_tpu_torch.interop import midrange_from_numpy
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.models import CompressedRenderer

VOLUMES = {
    "turbulence": lambda: turbulence_volume((16, 16, 16), seed=21),
    "sphere": lambda: np.round(sphere_volume((16, 16, 16)) * 255).astype(np.uint8),
    "random4": lambda: np.random.default_rng(5).integers(0, 256, (4, 4, 4)).astype(np.uint8),
}


def _kd_arrays(t):
    return [t.distance_map, *t.level_codes, t.chain_codes, t.leaf_recon, t.leaf_truth]


def _arrays(mt):
    return _kd_arrays(mt.mid) + [mt.range_distance_map, *mt.range_level_codes,
                                 mt.range_chain_codes, mt.leaf_recon_range, mt.leaf_truth_range]


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(VOLUMES))
def test_build_equals_jax_array_for_array(name):
    from volumerenderer_tpu.codecs import midrange as JM

    vol = VOLUMES[name]()
    mj = JM.build(vol, tolerance=2, max_epochs=2)
    mt = TM.build(vol, tolerance=2, max_epochs=2)
    _assert_same(_arrays(mt), _arrays(mj))
    assert mt.num_active_nodes == mj.num_active_nodes
    for field in ("dims", "orig_depth", "max_depth", "schedule", "tolerance", "max_epochs"):
        assert getattr(mt.mid, field) == getattr(mj.mid, field)
    assert int(mt.leaf_truth_range.max()) == 0  # a leaf's range is 0


@pytest.mark.parametrize("name", ["turbulence", "sphere"])
def test_mid_channel_equals_kdtree_build(name):
    vol = VOLUMES[name]()
    mt = TM.build(vol, tolerance=2, max_epochs=2)
    kt = TK.build(vol, tolerance=2, max_epochs=2)
    _assert_same(_kd_arrays(mt.mid), _kd_arrays(kt))
    assert mt.num_active_nodes == kt.num_active_nodes
    np.testing.assert_array_equal(TM.level_cut(mt), TK.level_cut(kt))
    # the structure's 3-codes coincide in both channels
    for cm, cr in zip(mt.mid.level_codes, mt.range_level_codes):
        np.testing.assert_array_equal(cm == 3, cr == 3)
    np.testing.assert_array_equal(mt.mid.chain_codes == 3, mt.range_chain_codes == 3)


def test_level_cuts_and_device_pair_equal_jax():
    from volumerenderer_tpu.codecs import midrange as JM
    from volumerenderer_tpu.codecs.device import level_cut_device as j_level_cut_device

    vol = VOLUMES["sphere"]()
    mj = JM.build(vol, tolerance=2, max_epochs=2)
    mt = midrange_from_numpy(**dataclasses.asdict(mj))
    _assert_same(_arrays(mt), _arrays(mj))
    np.testing.assert_array_equal(TM.level_cut(mt), JM.level_cut(mj))
    rng_cut = TM.level_cut_range(mt)
    np.testing.assert_array_equal(rng_cut, JM.level_cut_range(mj))
    assert rng_cut.shape == vol.shape and rng_cut.astype(int).mean() < 16
    mid_dev, rng_dev, spec = TM.to_device_pair(mt, device="cpu")
    mid_j, rng_j, spec_j = JM.to_device_pair(mj)
    assert spec == spec_j
    assert mid_dev.distance_map.device.type == "cpu"
    np.testing.assert_array_equal(TD.level_cut_device(mid_dev, spec).numpy(),
                                  np.asarray(j_level_cut_device(mid_j, spec_j)))
    np.testing.assert_array_equal(TD.level_cut_device(rng_dev, spec).numpy(),
                                  np.asarray(j_level_cut_device(rng_j, spec_j)))
    np.testing.assert_array_equal(TD.level_cut_device(rng_dev, spec).numpy(), rng_cut)


def test_midrange_from_numpy_rejects_unknown_fields():
    with pytest.raises(TypeError, match="expected the fields"):
        midrange_from_numpy(mid=None, bogus=1)


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("mode", ["compositing", "isosurface"])
def test_compressed_renderer_renders_the_mid_channel(mode, pooled):
    vol = VOLUMES["sphere"]()
    mt = TM.build(vol, tolerance=2, max_epochs=2)
    kt = TK.build(vol, tolerance=2, max_epochs=2)
    rays = generate_rays(Camera(width=32, height=32, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device="cpu")
    got = CompressedRenderer(mt, "cpu").make_plan(rays, mode=mode, iso_value=0.5, pooled=pooled,
                                                 max_samples=48)()
    want = CompressedRenderer(kt, "cpu").make_plan(rays, mode=mode, iso_value=0.5,
                                                  pooled=pooled, max_samples=48)()
    assert bool(torch.isfinite(got[0]).all())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rgb, _ = CompressedRenderer(mt, "cpu").render(rays, mode=mode)
    assert rgb.shape == (32, 32, 3)


def test_compressed_renderer_rejects_other_trees():
    with pytest.raises(TypeError, match="KdTree or a MidRangeTree"):
        CompressedRenderer(np.zeros((4, 4, 4), np.uint8), "cpu")
