"""The whole isosurface slice of the port against the JAX package.

The port's own path — ``Camera`` -> ``generate_rays`` -> ``IsosurfacePlan``
-> ``render`` — is held against JAX's ``generate_rays`` ->
``render_isosurface``, each on its own rays.  Bars: equal hit masks, rgb
within 1e-4 (the specular ``pow(x, 250)`` turns a 1-ulp difference of a dot
product into about 250 ulp).

The two ``generate_rays`` differ by an ulp on about half the direction
values.  On the busy surface at the volume median that moves one pixel of
the 64x48 turbulence scene by 3.1e-4 (hit masks still equal), so that case
holds the masks on each side's own rays and the colors on JAX's rays carried
over with ``interop.rays_from_numpy``."""
import math

import numpy as np
import pytest
import torch

import volumerenderer_tpu as J
from volumerenderer_tpu.io.synthetic import sphere_volume as sphere_volume_jax
from volumerenderer_tpu.io.synthetic import turbulence_volume as turbulence_volume_jax
from volumerenderer_tpu.ops.isosurface import render_isosurface as render_isosurface_jax
from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.interop import rays_from_numpy
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.models import best_isosurface_renderer
from volumerenderer_tpu_torch.ops.cuda.isosurface_kernel import IsosurfacePlan, volume_median
from volumerenderer_tpu_torch.ops.isosurface import render_isosurface


def _orbit(az_deg, width, height, camera_cls):
    a = math.radians(az_deg)
    return camera_cls(width=width, height=height,
                      position=(0.75 * math.sin(a), 0.0, -0.75 * math.cos(a)),
                      front=(-math.sin(a), 0.0, math.cos(a)))


def _render_both(cam_t, cam_j, vol_u8, iso, jax_rays_for_port=False):
    rays_j = J.generate_rays(cam_j)
    rgb_j, found_j = render_isosurface_jax(J.as_normalized_volume(vol_u8), rays_j.entry_uv,
                                           rays_j.direction, rays_j.hit, iso_value=iso)
    if jax_rays_for_port:
        rays = rays_from_numpy(*(np.asarray(a) for a in (rays_j.entry_uv, rays_j.direction,
                                                         rays_j.hit)), device="cpu")
    else:
        rays = generate_rays(cam_t, device="cpu")
    vol = as_normalized_volume(vol_u8, device="cpu")
    Z, Y, X = vol.shape
    rgb_t, found_t = IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit,
                                    (X, Y, Z)).render(vol, iso)
    H, W = cam_t.height, cam_t.width
    assert rgb_t.shape == (H, W, 3) and found_t.shape == (H, W)
    assert bool(torch.isfinite(rgb_t).all())
    assert 0 < int(found_t.sum()) < H * W
    return (rgb_t.numpy(), found_t.numpy()), (np.asarray(rgb_j), np.asarray(found_j))


@pytest.mark.parametrize("scene", ["turbulence_goldens", "sphere_orbit_28deg"])
def test_iso_slice_matches_jax(scene):
    W, H = 64, 48
    if scene == "turbulence_goldens":
        cams = Camera(width=W, height=H), J.Camera(width=W, height=H)
        vol_u8, iso = turbulence_volume((32, 32, 32), seed=99), 40.0 / 255.0
        np.testing.assert_array_equal(vol_u8, turbulence_volume_jax((32, 32, 32), seed=99))
    else:
        cams = _orbit(28.0, W, H, Camera), _orbit(28.0, W, H, J.Camera)
        vol_u8, iso = sphere_volume((40, 32, 48)), 0.5
        np.testing.assert_array_equal(vol_u8, sphere_volume_jax((40, 32, 48)))
    (rgb_t, found_t), (rgb_j, found_j) = _render_both(*cams, vol_u8, iso)
    np.testing.assert_array_equal(found_t, found_j)
    np.testing.assert_allclose(rgb_t, rgb_j, atol=1e-4, rtol=0)


def test_iso_slice_at_volume_median_matches_jax():
    W, H = 64, 48
    cams = Camera(width=W, height=H), J.Camera(width=W, height=H)
    vol_u8 = turbulence_volume((32, 32, 32), seed=99)
    iso = volume_median(as_normalized_volume(vol_u8, device="cpu"))
    (_, found_t), (_, found_j) = _render_both(*cams, vol_u8, iso)
    np.testing.assert_array_equal(found_t, found_j)
    (rgb_t, found_t), (rgb_j, found_j) = _render_both(*cams, vol_u8, iso,
                                                      jax_rays_for_port=True)
    assert int(found_t.sum()) > 1000  # a busy surface
    np.testing.assert_array_equal(found_t, found_j)
    np.testing.assert_allclose(rgb_t, rgb_j, atol=1e-4, rtol=0)


def test_best_isosurface_renderer_on_cpu():
    """On CPU tensors the registry renderer is the plain path."""
    vol = as_normalized_volume(turbulence_volume((16, 16, 16), seed=2), device="cpu")
    rays = generate_rays(Camera(width=24, height=16), device="cpu")
    iso = volume_median(vol)
    ref = render_isosurface(vol, rays.entry_uv, rays.direction, rays.hit, iso)
    best = best_isosurface_renderer()(vol, rays.entry_uv, rays.direction, rays.hit, iso)
    assert int(ref[1].sum()) > 0
    for r, b in zip(ref, best):
        assert torch.equal(r, b)
