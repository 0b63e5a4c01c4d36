"""The port's plain isosurface path against the JAX package's jnp one.

Inputs are made with numpy from a seed and handed to both.  Bars:
``bisection_refine``, ``gradient_normal`` and ``phong`` within 1e-6;
``render_isosurface`` with equal hit masks and rgb within 1e-4 (``pow(x, 250)``
turns a 1-ulp difference of a dot product into about 250 ulp of the
specular term); the goldens of tests/test_goldens.py; the GLSL oracle as
tests/test_raycast.py holds the jnp renderer to it (equal masks, 5e-3)."""
import numpy as np
import pytest
import torch

import volumerenderer_tpu as J
from volumerenderer_tpu.ops import isosurface as JI
from volumerenderer_tpu_torch import (Camera, as_normalized_volume, generate_rays,
                                      render_isosurface)
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.ops import isosurface as TI
from volumerenderer_tpu_torch.ops.cuda.isosurface_kernel import volume_median
from volumerenderer_tpu_torch.ops.raycast import step_sizes
from oracles.glsl_oracle import render_isosurface_oracle


def _jax_rays(width, height, position=(0.0, 0.0, -0.75)):
    front = -np.asarray(position, np.float64)
    rays = J.generate_rays(J.Camera(width=width, height=height, position=position,
                                    front=tuple(front / np.linalg.norm(front))))
    return tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _points(seed, n=4096, lo=-0.1, hi=1.1):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def _unit(seed, n=4096):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_reference_constants():
    assert (TI.MAX_SAMPLES, TI.DELTA, TI.SPEC_POWER, TI.DIFFUSE) == \
        (JI.MAX_SAMPLES, JI.DELTA, JI.SPEC_POWER, JI.DIFFUSE)


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_bisection_refine_matches_jax(wrap):
    vol_u8 = turbulence_volume((16, 24, 32), seed=3)
    left = _points(1)
    right = left + _unit(2) * np.float32(0.05)
    iso = float(np.median(vol_u8)) / 255.0
    got = TI.bisection_refine(as_normalized_volume(vol_u8, device="cpu"), *_torch(left, right),
                              iso, wrap)
    ref = JI.bisection_refine(J.as_normalized_volume(vol_u8), left, right, iso, wrap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_gradient_normal_matches_jax(wrap):
    vol_u8 = turbulence_volume((16, 24, 32), seed=4)
    uvw = _points(5)
    got = TI.gradient_normal(as_normalized_volume(vol_u8, device="cpu"), torch.from_numpy(uvw),
                             wrap)
    ref = JI.gradient_normal(J.as_normalized_volume(vol_u8), uvw, wrap)
    assert float(got.abs().max()) > 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_gradient_normal_of_a_flat_volume_is_zero():
    vol = torch.full((8, 8, 8), 0.5)
    assert torch.equal(TI.gradient_normal(vol, torch.from_numpy(_points(6, n=16))),
                       torch.zeros(16, 3))


def test_phong_matches_jax():
    V, N = _unit(7), _unit(8)
    N[:64] = V[:64]  # head-on: the specular peak
    got = TI.phong(*_torch(V, N, V))
    ref = JI.phong(V, N, V)
    assert float(got.max()) > 1.0  # unclipped: diffuse + spec exceeds 1 at the peak
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def _scene(kind):
    if kind == "sphere":
        return sphere_volume((32, 32, 32)), _jax_rays(48, 40, (0.2, -0.15, -0.7)), 0.5
    return turbulence_volume((32, 32, 32), seed=99), _jax_rays(64, 48), 40.0 / 255.0


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("kind", ["sphere", "goldens"])
def test_render_isosurface_matches_jax(kind, wrap):
    vol_u8, rays, iso = _scene(kind)
    rgb_t, f_t = render_isosurface(as_normalized_volume(vol_u8, device="cpu"), *_torch(*rays),
                                   iso_value=iso, wrap=wrap)
    rgb_j, f_j = JI.render_isosurface(J.as_normalized_volume(vol_u8), *rays, iso_value=iso,
                                      wrap=wrap)
    assert int(f_t.sum()) >= 18  # the scene has a surface
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-4, rtol=0)


def test_golden_isosurface():
    """The pin of tests/test_goldens.py, through the port alone."""
    vol = as_normalized_volume(turbulence_volume((32, 32, 32), seed=99), device="cpu")
    rays = generate_rays(Camera(width=64, height=48), device="cpu")
    rgb, found = render_isosurface(vol, rays.entry_uv, rays.direction, rays.hit)
    assert abs(float(rgb.sum()) - 9185.606445) < 0.05
    assert int(found.sum()) == 18


def test_isosurface_matches_glsl_oracle():
    vol_u8 = sphere_volume((32, 32, 32))
    W, H = 40, 30
    rays = generate_rays(Camera(width=W, height=H), device="cpu")
    rgb, found = render_isosurface(as_normalized_volume(vol_u8, device="cpu"), rays.entry_uv,
                                   rays.direction, rays.hit, iso_value=40.0 / 255.0)
    ref_rgb, ref_hit = render_isosurface_oracle(vol_u8, W, H, iso=40.0 / 255.0)
    assert ref_hit.any()
    np.testing.assert_array_equal(found.numpy(), ref_hit)
    np.testing.assert_allclose(rgb.numpy(), ref_rgb, atol=5e-3, rtol=0)


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_march_then_shade_is_render_isosurface(wrap):
    vol_u8, rays, iso = _scene("goldens")
    vol = as_normalized_volume(vol_u8, device="cpu")
    entry_uv, direction, hit = _torch(*rays)
    dir_step = direction * step_sizes((32, 32, 32), "cpu")
    found, t_hit = TI.iso_march_steps(vol, entry_uv, dir_step, hit, iso, wrap=wrap)
    assert found.dtype == torch.bool and t_hit.dtype == torch.int32
    assert bool((t_hit[~found] == -1).all()) and bool((t_hit[found] >= 0).all())
    rgb = TI.shade_hits(vol, entry_uv, dir_step, direction, found, t_hit, iso, wrap)
    ref_rgb, ref_found = render_isosurface(vol, entry_uv, direction, hit, iso, wrap=wrap)
    assert torch.equal(found, ref_found) and torch.equal(rgb, ref_rgb)


def test_march_hit_bracket_straddles_iso():
    """At ``t_hit`` the sample at ``entry + (t_hit+1)`` steps is below iso
    and the next one is not — the bracket the shade pass refines."""
    from volumerenderer_tpu_torch.ops.sampling import sample_trilinear

    vol_u8, rays, iso = _scene("sphere")
    vol = as_normalized_volume(vol_u8, device="cpu")
    entry_uv, direction, hit = _torch(*rays)
    dir_step = direction * step_sizes((32, 32, 32), "cpu")
    found, t_hit = TI.iso_march_steps(vol, entry_uv, dir_step, hit, iso)
    near = entry_uv.clone()
    for k in range(int(t_hit.max()) + 1):
        near = torch.where((t_hit >= k)[..., None], near + dir_step, near)
    iso32 = torch.tensor(iso, dtype=torch.float32)
    assert bool((sample_trilinear(vol, near)[found] < iso32).all())
    assert bool((sample_trilinear(vol, near + dir_step)[found] >= iso32).all())


@pytest.mark.parametrize("shape", [(8, 6, 10), (5, 7, 9)])
def test_volume_median_equals_numpy(shape):
    vol_u8 = turbulence_volume(shape, seed=11)
    vol = as_normalized_volume(vol_u8, device="cpu")
    assert volume_median(vol) == float(np.median(vol.numpy()))
    assert volume_median(torch.tensor([1.0, 2.0, 3.0, 4.0])) == 2.5  # torch.median says 2.0
