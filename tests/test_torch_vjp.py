"""The port's O(1)-memory VJP (``diff/vjp.py::render_tf_o1``) against the JAX
package's ``render_tf_o1`` and against torch autograd through the port's own
``render_tf``, as ``tests/test_vjp_o1.py`` holds the JAX one.  Inputs: a 16³
turbulence volume and 16x16 rays, made from seeds with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderer_tpu as J
from volumerenderer_tpu.diff.transfer import TFParams as JTFParams
from volumerenderer_tpu.diff.vjp import render_tf_o1 as render_tf_o1_jax
from volumerenderer_tpu.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch import TFParams, render_tf
from volumerenderer_tpu_torch.diff.vjp import render_tf_o1
from volumerenderer_tpu_torch.interop import rays_from_numpy, tf_params_from_numpy


def _jax_params(kind):
    if kind == "reference":
        return JTFParams.reference()
    return JTFParams(alpha_scale=jnp.float32(0.45), color_gain=jnp.float32(0.9),
                     color_bias=jnp.float32(0.05),
                     flip_sign=jnp.array([-0.8, 0.6, 0.3], jnp.float32),
                     flip_bias=jnp.array([0.9, 0.2, 0.4], jnp.float32))


def _scene(scale=1.0):
    vol = np.asarray(J.as_normalized_volume(turbulence_volume((16, 16, 16), seed=8))) * scale
    rays = J.generate_rays(J.Camera(width=16, height=16))
    return vol.astype(np.float32), tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction,
                                                               rays.hit))


def _port_leaves(params_j, vol):
    fields = {k: np.asarray(v) for k, v in params_j._asdict().items()}
    params = TFParams(*(t.requires_grad_(True)
                        for t in tf_params_from_numpy(**fields, device="cpu")))
    return params, torch.tensor(vol, requires_grad=True)


def _weights(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((16, 16, 3)).astype(np.float32),
            rng.standard_normal((16, 16)).astype(np.float32))


@pytest.mark.parametrize("kind", ["reference", "non_reference"])
def test_o1_matches_jax_o1(kind):
    """Forward within 1e-6; gradients of every param and voxel within 1e-5
    relative to max(1, max |g|), 200x below test_vjp_o1.py's bars: the same
    algorithm in the same op order, apart from the order of sums."""
    vol, (e, d, h) = _scene()
    pj = _jax_params(kind)
    w_rgb, w_a = _weights(3)

    def loss_j(p, v):
        rgb, a = render_tf_o1_jax(p, v, e, d, h, 48, True)
        return jnp.sum(rgb * w_rgb) + jnp.sum(a * w_a)

    rgb_j, a_j = render_tf_o1_jax(pj, jnp.asarray(vol), e, d, h, 48)
    gp_j, gv_j = jax.grad(loss_j, argnums=(0, 1))(pj, jnp.asarray(vol))

    rays = rays_from_numpy(e, d, h, device="cpu")
    params, vt = _port_leaves(pj, vol)
    rgb, a = render_tf_o1(params, vt, rays.entry_uv, rays.direction, rays.hit, 48)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(a_j), atol=1e-6, rtol=0)
    loss = torch.sum(rgb * torch.tensor(w_rgb)) + torch.sum(a * torch.tensor(w_a))
    *gp, gv = torch.autograd.grad(loss, [*params, vt])
    for name, g_t, g_j in zip(TFParams._fields, gp, gp_j):
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(g_j).max()), err_msg=name)
    gv_j = np.asarray(gv_j)
    assert np.abs(gv_j).max() > 0.1
    np.testing.assert_allclose(gv.numpy(), gv_j, rtol=0, atol=1e-5 * max(1.0, np.abs(gv_j).max()))


def test_o1_gradients_match_autograd_through_render_tf():
    """test_vjp_o1.py's check in the port: the reverse-recurrence VJP vs
    torch autograd through the port's ``render_tf`` loop, moderate density
    (saturating and pass-through rays), same bars."""
    vol, (e, d, h) = _scene()
    rays = rays_from_numpy(e, d, h, device="cpu")
    target = torch.full((16, 16, 3), 0.4)
    grads = []
    for render in (render_tf, render_tf_o1):
        params, vt = _port_leaves(JTFParams.reference(), vol)
        rgb, _ = render(params, vt, rays.entry_uv, rays.direction, rays.hit, 48)
        grads.append(torch.autograd.grad(torch.sum((rgb - target) ** 2), [*params, vt]))
    (*gp_a, gv_a), (*gp_b, gv_b) = grads
    for name, a, b in zip(TFParams._fields, gp_a, gp_b):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(gv_b.numpy(), gv_a.numpy(), rtol=5e-3, atol=1e-4)


def test_o1_pixel_gradients_match_finite_differences():
    """test_vjp_o1.py's finite-difference check: low density keeps every ray
    away from the 0.99 threshold; the five most influential voxels of one
    pixel, central differences with eps 1e-3, bar 5e-3 * max(1, |fd|)."""
    vol, (e, d, h) = _scene(scale=0.2)
    rays = rays_from_numpy(e, d, h, device="cpu")
    p = TFParams.reference(device="cpu")
    pix = (7, 9)

    def pixel(v):
        rgb, _ = render_tf_o1(p, v, rays.entry_uv, rays.direction, rays.hit, 24)
        return rgb[pix[0], pix[1], 0]

    vt = torch.tensor(vol, requires_grad=True)
    (g,) = torch.autograd.grad(pixel(vt), [vt])
    g = g.numpy()
    eps = 1e-3
    for idx in np.argsort(np.abs(g).ravel())[-5:]:
        z, y, x = np.unravel_index(idx, vol.shape)
        vp, vm = vol.copy(), vol.copy()
        vp[z, y, x] += eps
        vm[z, y, x] -= eps
        with torch.no_grad():
            fd = (float(pixel(torch.tensor(vp))) - float(pixel(torch.tensor(vm)))) / (2 * eps)
        assert abs(fd - g[z, y, x]) < 5e-3 * max(1.0, abs(fd)), (fd, g[z, y, x])


def test_volume_grad_skippable():
    """``compute_volume_grad=False`` skips the scatter: the param gradients
    are unchanged and the volume's is zeros, as in JAX."""
    vol, (e, d, h) = _scene()
    rays = rays_from_numpy(e, d, h, device="cpu")
    out = {}
    for flag in (True, False):
        params, vt = _port_leaves(JTFParams.reference(), vol)
        rgb, _ = render_tf_o1(params, vt, rays.entry_uv, rays.direction, rays.hit, 32, flag)
        out[flag] = torch.autograd.grad(torch.sum(rgb ** 2), [*params, vt])
    for a, b in zip(out[True][:5], out[False][:5]):
        assert torch.equal(a, b)
    assert torch.isfinite(out[False][0])
    assert float(out[True][5].abs().max()) > 0 and not bool(out[False][5].any())


def test_o1_forward_against_render_tf_measures_position_rounding():
    """``render_tf_o1`` samples at analytic positions ``entry + (t+1)*step``
    and ``render_tf`` (like the kernels) at ``pos += step``: the forwards
    agree to rounding, here within test_vjp_o1.py's 1e-6 bar, and not
    necessarily bit for bit (its JAX docstring's "exactly" does not hold)."""
    vol, (e, d, h) = _scene()
    rays = rays_from_numpy(e, d, h, device="cpu")
    p = TFParams.reference(device="cpu")
    vt = torch.tensor(vol)
    pos_rec = rays.entry_uv
    step = rays.direction * torch.tensor([1 / 16, 1 / 16, 1 / 16])
    pos_diff = 0.0
    for t in range(64):
        pos_rec = pos_rec + step
        pos_diff = max(pos_diff, float((pos_rec - (rays.entry_uv + (t + 1.0) * step)).abs().max()))
    # the two position rules differ by the rounding 64 additions accumulate
    assert 0.0 < pos_diff < 1e-5
    rgb_a, a_a = render_tf(p, vt, rays.entry_uv, rays.direction, rays.hit, 64)
    with torch.no_grad():
        rgb_b, a_b = render_tf_o1(p, vt, rays.entry_uv, rays.direction, rays.hit, 64)
    assert float((rgb_a - rgb_b).abs().max()) <= 1e-6
    assert float((a_a - a_b).abs().max()) <= 1e-6
