"""The whole compositing slice of the port against the JAX package.

The port's own path — ``Camera`` -> ``generate_rays`` -> ``plan_compositing``
-> ``render`` — is held against JAX's ``generate_rays`` ->
``render_compositing`` (the CPU path of ``__graft_entry__.entry()``), each on
its own rays.  Bar: max |d| <= 1e-5 on rgb and alpha.  Ray generation may
differ by an ulp, and where that moves a ray across the 0.99 early-out the
pixel differs by one composite step (pa <= 0.01); such knife-edge pixels are
allowed on at most 0.5% of the image, each within 1.5e-2, and reported."""
import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch

import volumerenderer_tpu as J
from volumerenderer_tpu.io.synthetic import turbulence_volume as turbulence_volume_jax
from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.interop import (camera_from_jax_fields, rays_from_numpy,
                                              volume_from_numpy)
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.models import (best_renderer, plan_compositing,
                                             reference_renderer)


def _orbit(az_deg, width, height, camera_cls):
    a = math.radians(az_deg)
    return camera_cls(width=width, height=height,
                      position=(0.75 * math.sin(a), 0.0, -0.75 * math.cos(a)),
                      front=(-math.sin(a), 0.0, math.cos(a)))


def _assert_slice_close(ours, ref, what):
    n_px = ref.shape[0] * ref.shape[1]
    d = np.abs(ours - ref)
    if d.ndim == 3:
        d = d.max(axis=-1)
    knife = int((d > 1e-5).sum())
    assert knife <= 0.005 * n_px, f"{what}: {knife} px beyond 1e-5"
    assert float(d.max()) <= 1.5e-2, f"{what}: max |d| {float(d.max())}"
    if knife:
        warnings.warn(f"{what}: {knife} early-out knife-edge px beyond 1e-5 "
                      f"(max |d| {float(d.max()):.3g})")


@pytest.mark.parametrize("az_deg", [None, 24.0])
def test_slice_matches_jax_entry_path(az_deg):
    W, H = 64, 48
    if az_deg is None:
        cam_t, cam_j = Camera(width=W, height=H), J.Camera(width=W, height=H)
    else:
        cam_t, cam_j = _orbit(az_deg, W, H, Camera), _orbit(az_deg, W, H, J.Camera)
    vol_u8 = turbulence_volume((32, 32, 32), seed=99)

    vol = as_normalized_volume(vol_u8, device="cpu")
    rays = generate_rays(cam_t, device="cpu")
    Z, Y, X = vol.shape
    rgb_t, a_t = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z)).render(vol)

    rays_j = J.generate_rays(cam_j)
    rgb_j, a_j = J.render_compositing(J.as_normalized_volume(turbulence_volume_jax(
        (32, 32, 32), seed=99)), rays_j.entry_uv, rays_j.direction, rays_j.hit)

    assert rgb_t.shape == (H, W, 3) and a_t.shape == (H, W)
    assert torch.isfinite(rgb_t).all() and torch.isfinite(a_t).all()
    assert float(a_t.max()) > 0.9
    _assert_slice_close(rgb_t.numpy(), np.asarray(rgb_j), "rgb")
    _assert_slice_close(a_t.numpy(), np.asarray(a_j), "alpha")


def test_renderer_registry_on_cpu():
    """On CPU tensors both registry renderers are the plain march."""
    vol = as_normalized_volume(turbulence_volume((16, 16, 16), seed=2), device="cpu")
    rays = generate_rays(Camera(width=24, height=16), device="cpu")
    ref = reference_renderer()(vol, rays.entry_uv, rays.direction, rays.hit)
    best = best_renderer()(vol, rays.entry_uv, rays.direction, rays.hit)
    for r, b in zip(ref, best):
        assert torch.equal(r, b)


def test_interop_round_trip():
    """A JAX run's camera, rays and volume, carried over as numpy, render in
    the port exactly as the JAX renderer renders them."""
    cam_j = _orbit(12.0, 40, 30, J.Camera)
    cam_t = camera_from_jax_fields(**dataclasses.asdict(cam_j))
    assert dataclasses.asdict(cam_t) == dataclasses.asdict(cam_j)
    assert cam_t == _orbit(12.0, 40, 30, Camera)

    vol_u8 = turbulence_volume_jax((16, 20, 24), seed=4)
    rays_j = J.generate_rays(cam_j)
    rays = rays_from_numpy(np.asarray(rays_j.entry_uv), np.asarray(rays_j.direction),
                           np.asarray(rays_j.hit), device="cpu")
    assert rays.hit.dtype == torch.bool and rays.entry_uv.dtype == torch.float32
    np.testing.assert_array_equal(rays.entry_uv.numpy(), np.asarray(rays_j.entry_uv))
    np.testing.assert_array_equal(rays.hit.numpy(), np.asarray(rays_j.hit))

    vol = volume_from_numpy(vol_u8, device="cpu")
    vol_j = J.as_normalized_volume(vol_u8)
    np.testing.assert_array_equal(vol.numpy(), np.asarray(vol_j))
    np.testing.assert_array_equal(volume_from_numpy(np.asarray(vol_j), device="cpu").numpy(),
                                  np.asarray(vol_j))

    Z, Y, X = vol.shape
    rgb_t, a_t = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z),
                                  max_samples=64).render(vol)
    rgb_j, a_j = J.render_compositing(vol_j, rays_j.entry_uv, rays_j.direction, rays_j.hit,
                                      max_samples=64)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint8), np.zeros((2, 2, 2), np.int32)])
def test_interop_rejects_bad_volume(bad):
    with pytest.raises(ValueError):
        volume_from_numpy(bad, device="cpu")


def test_interop_rejects_bad_rays():
    with pytest.raises(ValueError):
        rays_from_numpy(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)), np.zeros((4, 5), bool),
                        device="cpu")
