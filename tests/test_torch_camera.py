"""Port ray generation vs the JAX package's ``generate_rays``.

Both compute in float32 in the same operation order; norms and cross products
may round differently by an ulp, so positions and directions are held to
1e-6 and the hit mask exactly."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import volumerenderer_tpu as J
import volumerenderer_tpu_torch as T
from volumerenderer_tpu_torch.camera import look_at_basis
from volumerenderer_tpu_torch.interop import camera_from_jax_fields


def _orbit_jax_camera(az_deg, width, height):
    """``bench.orbit_camera``: the default eye orbited around +y."""
    a = math.radians(az_deg)
    return J.Camera(width=width, height=height,
                    position=(0.75 * math.sin(a), 0.0, -0.75 * math.cos(a)),
                    front=(-math.sin(a), 0.0, math.cos(a)))


def _assert_rays_close(rt, rj):
    np.testing.assert_allclose(rt.entry_uv.numpy(), np.asarray(rj.entry_uv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rt.direction.numpy(), np.asarray(rj.direction), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(rt.hit.numpy(), np.asarray(rj.hit))


def test_camera_defaults_match():
    assert dataclasses.asdict(T.Camera()) == dataclasses.asdict(J.Camera())
    assert T.Camera().aspect == J.Camera().aspect


def test_default_camera_rays_match_jax():
    rt = T.generate_rays(T.Camera(), 64, 48, device="cpu")
    rj = J.generate_rays(J.Camera(), 64, 48)
    assert rt.entry_uv.shape == (48, 64, 3) and rt.entry_uv.dtype == torch.float32
    assert rt.hit.dtype == torch.bool
    _assert_rays_close(rt, rj)


@pytest.mark.parametrize("az_deg", [0.0, 10.0, 30.0])
def test_orbit_camera_rays_match_jax(az_deg):
    cam_j = _orbit_jax_camera(az_deg, 64, 48)
    cam_t = camera_from_jax_fields(**dataclasses.asdict(cam_j))
    rt = T.generate_rays(cam_t, device="cpu")
    rj = J.generate_rays(cam_j)
    assert np.asarray(rj.hit).any()
    _assert_rays_close(rt, rj)


def test_look_at_basis_matches_jax():
    from volumerenderer_tpu.camera import look_at_basis as look_at_basis_jax

    rng = np.random.default_rng(4)
    for _ in range(5):
        front = rng.standard_normal(3).astype(np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        bt = look_at_basis(None, torch.from_numpy(front), torch.from_numpy(up))
        bj = look_at_basis_jax(None, front, up)
        for a, b in zip(bt, bj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
