"""The port's ``CompressedRenderer`` against the JAX package's, on one tree.

The JAX package builds the tree of tests/test_pallas_interpret.py:260-283
(16x16x256, tolerance 1, 2 epochs); ``interop.kdtree_from_numpy`` carries it
into the port, and both render JAX's rays at ``max_samples=24``.  The JAX
side renders through its jnp renderers (``CompressedRenderer.render``), the
port through ``make_plan(pooled=True)``: compositing within 1e-5, the
isosurface with equal hit masks and rgb within 2e-3 (JAX's shade rebuilds
the bracket as ``entry + (t_hit + 1) * step``, the port by repeated
addition, as the reference shader marches)."""
import dataclasses

import numpy as np
import pytest
import torch

import volumerenderer_tpu as J
from volumerenderer_tpu.codecs.kdtree import build as build_jax
from volumerenderer_tpu.models.compressed import CompressedRenderer as JaxCompressedRenderer
from volumerenderer_tpu.models.compressed import DenseRenderer as JaxDenseRenderer
from volumerenderer_tpu_torch.interop import kdtree_from_numpy, rays_from_numpy
from volumerenderer_tpu_torch.models import CompressedRenderer, DenseRenderer
from volumerenderer_tpu_torch.models import compressed as MC
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK

ISO = 0.5


def _data():
    Z, Y, X = 16, 16, 256
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X), indexing="ij")
    r = np.sqrt(((xx - X / 2) / (X / 2)) ** 2 + ((yy - Y / 2) / (Y / 2)) ** 2
                + ((zz - Z / 2) / (Z / 2)) ** 2)
    return np.clip(255.0 * (1.0 - r), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def scene():
    tree_j = build_jax(_data(), tolerance=1, max_epochs=2)
    rays_j = J.generate_rays(J.Camera(width=64, height=32))
    rays = rays_from_numpy(*(np.asarray(a) for a in (rays_j.entry_uv, rays_j.direction,
                                                     rays_j.hit)), device="cpu")
    return tree_j, kdtree_from_numpy(**dataclasses.asdict(tree_j)), rays_j, rays


def test_make_plan_pooled_matches_jax_compressed_renderer(scene):
    tree_j, tree, rays_j, rays = scene
    jax_ren = JaxCompressedRenderer(tree_j)
    ren = CompressedRenderer(tree, device="cpu")
    rgb_j, a_j = jax_ren.render(rays_j, mode="compositing", max_samples=24)
    rgb, a = ren.make_plan(rays, mode="compositing", max_samples=24, pooled=True)()
    assert float(a.sum()) > 100
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)

    rgb_j, found_j = jax_ren.render(rays_j, mode="isosurface", iso_value=ISO, max_samples=24)
    rgb, found = ren.make_plan(rays, mode="isosurface", iso_value=ISO, max_samples=24,
                               pooled=True)()
    assert int(found.sum()) > 100
    np.testing.assert_array_equal(found.numpy(), np.asarray(found_j))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=2e-3, rtol=0)
    # the pooled plans kept no dense volume, only the pools
    assert ren._cache == {}
    assert set(ren._pool_cache) == {(tree.max_depth, "pair16"), (tree.max_depth, "narrowf32")}


@pytest.mark.parametrize("mode", ["compositing", "isosurface"])
@pytest.mark.parametrize("cut", ["full", "leaf_depth", "coarse"])
def test_make_plan_pooled_equals_dense_plan(scene, mode, cut):
    _, tree, _, rays = scene
    cut_depth = {"full": None, "leaf_depth": tree.orig_depth, "coarse": 9}[cut]
    ren = CompressedRenderer(tree, device="cpu")
    pooled = ren.make_plan(rays, cut_depth, mode=mode, iso_value=ISO, max_samples=40,
                           pooled=True)()
    dense = ren.make_plan(rays, cut_depth, mode=mode, iso_value=ISO, max_samples=40)()
    for p, d in zip(pooled, dense):
        assert torch.equal(p, d)
    # and the dense plan is the plain render of the decoded cut
    plain = ren.render(rays, cut_depth, mode=mode, max_samples=40,
                       **({"iso_value": ISO} if mode == "isosurface" else {}))
    for p, d in zip(plain, dense):
        assert torch.equal(p, d)


def test_pools_come_from_the_tree_occupancy(scene):
    _, tree, _, _ = scene
    ren = CompressedRenderer(tree, device="cpu")
    for fmt, build in (("pair16", RK.build_slab_pool), ("narrowf32", RK.build_slab_pool_narrow)):
        pool, smap = ren.slab_pool_at(fmt=fmt)
        want_pool, want_map = build(ren.volume_at())
        assert torch.equal(pool, want_pool) and torch.equal(smap, want_map)
        assert ren.slab_pool_at(fmt=fmt)[0] is pool  # cached
    assert torch.equal(ren.mip8_at(), RK.block_max8(ren.volume_at()))
    with pytest.raises(ValueError, match="pool format"):
        ren.slab_pool_at(fmt="f16")


def test_decoded_has_no_host_fallback(scene, monkeypatch):
    """A failed device decode propagates, whatever it says: no quiet switch
    to the host decode (the JAX class's fallback at compressed.py:81-95)."""
    _, tree, _, rays = scene

    def out_of_memory(*_args, **_kwargs):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory while decoding")

    monkeypatch.setattr(MC, "level_cut_device", out_of_memory)
    ren = CompressedRenderer(tree, device="cpu")
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        ren.volume_at()
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        ren.make_plan(rays, mode="compositing", pooled=True)
    assert ren._cache == {} and ren._pool_cache == {}


def test_render_fast_and_dense_renderer(scene):
    tree_j, tree, rays_j, rays = scene
    ren = CompressedRenderer(tree, device="cpu")
    for mode in ("compositing", "isosurface"):
        slow = ren.render(rays, mode=mode, max_samples=24)
        fast = ren.render(rays, mode=mode, fast=True, max_samples=24)
        for s, f in zip(slow, fast):
            assert torch.equal(s, f)
    vol_u8 = (ren.volume_at() * 255.0).round().to(torch.uint8).numpy()
    rgb_j, a_j = JaxDenseRenderer(vol_u8).render(rays_j, max_samples=24)
    dense = DenseRenderer(vol_u8, device="cpu")
    assert dense.volume_at(3) is dense.volume_at()
    rgb, a = dense.render(rays, max_samples=24)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="mode"):
        dense.render(rays, mode="mip")
    with pytest.raises(ValueError, match="mode"):
        ren.make_plan(rays, mode="mip")


def test_compressed_renderer_takes_only_a_kdtree():
    with pytest.raises(TypeError, match="KdTree"):
        CompressedRenderer(np.zeros((8, 8, 8), np.uint8), device="cpu")
