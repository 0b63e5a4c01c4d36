"""Port compositing march (plain PyTorch) vs the JAX package's, the goldens
and the scalar GLSL oracle.

Both sides march the same numpy rays through the same byte-derived volume.
The bar against JAX is the one the JAX kernel is held to (atol 1e-5); the
oracle bar is the JAX renderer's own (2e-4)."""
import numpy as np
import pytest
import torch

import volumerenderer_tpu as J
from volumerenderer_tpu.ops import raycast as JR
from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.ops import raycast as TR
from oracles.glsl_oracle import render_compositing_oracle


def _scene(seed=5, shape=(16, 24, 32), width=40, height=30, position=(0.2, -0.1, -0.7)):
    rng = np.random.default_rng(seed)
    vol_u8 = np.round(rng.random(shape) * 255.0).astype(np.uint8)
    front = -np.asarray(position, np.float64)
    rays = J.generate_rays(J.Camera(width=width, height=height, position=position,
                                    front=tuple(front / np.linalg.norm(front))))
    return vol_u8, tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_composite_march_matches_jax(early_exit, wrap):
    vol_u8, rays = _scene()
    vol_j = J.as_normalized_volume(vol_u8)
    march_j = JR.composite_march_early_exit if early_exit else JR.composite_march
    march_t = TR.composite_march_early_exit if early_exit else TR.composite_march
    cj, aj = march_j(vol_j, *rays, max_samples=64, wrap=wrap)
    ct, at = march_t(as_normalized_volume(vol_u8, device="cpu"), *_torch(*rays), max_samples=64,
                     wrap=wrap)
    assert float(np.asarray(aj).max()) > 0.5  # the scene composites something
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-5, rtol=0)


def test_early_exit_equals_fixed_trip():
    vol_u8, rays = _scene(seed=8)
    vol = as_normalized_volume(vol_u8, device="cpu")
    c0, a0 = TR.composite_march(vol, *_torch(*rays), max_samples=TR.MAX_SAMPLES)
    c1, a1 = TR.composite_march_early_exit(vol, *_torch(*rays), max_samples=TR.MAX_SAMPLES)
    assert torch.equal(c0, c1) and torch.equal(a0, a1)


def test_reference_constants():
    assert (TR.MAX_SAMPLES, TR.ALPHA_SCALE, TR.EARLY_OUT_ALPHA) == \
        (JR.MAX_SAMPLES, JR.ALPHA_SCALE, JR.EARLY_OUT_ALPHA) == (300, 0.6, 0.99)


def test_golden_compositing():
    """The pins of tests/test_goldens.py, through the port alone."""
    vol = as_normalized_volume(turbulence_volume((32, 32, 32), seed=99), device="cpu")
    rays = generate_rays(Camera(width=64, height=48), device="cpu")
    rgb, a = TR.render_compositing(vol, rays.entry_uv, rays.direction, rays.hit)
    assert abs(float(rgb.sum()) - 3667.208252) < 0.02
    assert abs(float(a.sum()) - 3046.968750) < 0.02


def test_golden_compositing_fixed_trip():
    vol = as_normalized_volume(turbulence_volume((32, 32, 32), seed=99), device="cpu")
    rays = generate_rays(Camera(width=64, height=48), device="cpu")
    rgb, a = TR.render_compositing(vol, rays.entry_uv, rays.direction, rays.hit,
                                   early_exit=False)
    assert abs(float(rgb.sum()) - 3667.208252) < 0.02
    assert abs(float(a.sum()) - 3046.968750) < 0.02


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_compositing_matches_glsl_oracle(wrap):
    vol_u8 = sphere_volume((16, 16, 16))
    W, H = 12, 10
    rays = generate_rays(Camera(width=W, height=H), device="cpu")
    rgb, alpha = TR.render_compositing(as_normalized_volume(vol_u8, device="cpu"), rays.entry_uv,
                                       rays.direction, rays.hit, wrap=wrap)
    ref_rgb, ref_alpha = render_compositing_oracle(vol_u8, W, H, wrap=wrap)
    assert ref_alpha.max() > 0.5
    np.testing.assert_allclose(rgb.numpy(), ref_rgb, atol=2e-4, rtol=0)
    np.testing.assert_allclose(alpha.numpy(), ref_alpha, atol=2e-4, rtol=0)


def test_reference_transfer():
    c = torch.tensor([[0.0, 0.25], [0.5, 1.0]])
    rgb = TR.apply_reference_transfer(c, torch.zeros_like(c))
    assert rgb.shape == (2, 2, 3)
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(
        JR.apply_reference_transfer(c.numpy(), np.zeros((2, 2), np.float32))))
