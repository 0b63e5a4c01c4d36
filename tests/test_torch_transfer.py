"""The port's differentiable TF render (``diff/transfer.py``) against the JAX
package's, on the same inputs: a 16³ turbulence volume and 16x16 rays, made
from seeds with numpy.  Bars: outputs within 1e-6; torch-autograd gradients
of ``render_tf`` within ``tests/test_vjp_o1.py``'s bars of ``jax.grad``
(params rtol 2e-3 / atol 1e-5, voxels rtol 5e-3 / atol 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderer_tpu as J
from volumerenderer_tpu.diff.transfer import TFParams as JTFParams
from volumerenderer_tpu.diff.transfer import render_tf as render_tf_jax
from volumerenderer_tpu.diff.transfer import tf_loss as tf_loss_jax
from volumerenderer_tpu.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch import TFParams, render_tf
from volumerenderer_tpu_torch.diff.transfer import tf_loss
from volumerenderer_tpu_torch.interop import rays_from_numpy, tf_params_from_numpy
from volumerenderer_tpu_torch.ops.raycast import render_compositing

MAX_SAMPLES = 48


def _jax_params():
    """The non-reference params of tests/test_pallas_interpret.py."""
    return JTFParams(alpha_scale=jnp.float32(0.45), color_gain=jnp.float32(0.9),
                     color_bias=jnp.float32(0.05),
                     flip_sign=jnp.array([-0.8, 0.6, 0.3], jnp.float32),
                     flip_bias=jnp.array([0.9, 0.2, 0.4], jnp.float32))


def _as_numpy(params):
    return {k: np.asarray(v) for k, v in params._asdict().items()}


def _scene():
    vol = np.asarray(J.as_normalized_volume(turbulence_volume((16, 16, 16), seed=8)))
    rays = J.generate_rays(J.Camera(width=16, height=16))
    return vol, tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


def test_reference_params_give_the_reference_render():
    p = TFParams.reference(device="cpu")
    assert [float(x) for x in (p.alpha_scale, p.color_gain, p.color_bias)] == \
        pytest.approx([0.6, 1.0, 0.0])
    assert p.flip_sign.tolist() == [-1.0, -1.0, 0.0] and p.flip_bias.tolist() == [1.0, 1.0, 1.0]
    assert all(t.dtype == torch.float32 for t in p)
    assert p.alpha_scale.dim() == 0 and p.flip_sign.shape == (3,)
    vol, (e, d, h) = _scene()
    rays = rays_from_numpy(e, d, h, device="cpu")
    vt = torch.tensor(vol)
    got = render_tf(p, vt, rays.entry_uv, rays.direction, rays.hit, MAX_SAMPLES)
    ref = render_compositing(vt, rays.entry_uv, rays.direction, rays.hit, MAX_SAMPLES)
    assert float(ref[1].max()) > 0.9
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_render_tf_matches_jax(wrap):
    vol, (e, d, h) = _scene()
    pj = _jax_params()
    rgb_j, a_j = render_tf_jax(pj, jnp.asarray(vol), e, d, h, max_samples=MAX_SAMPLES, wrap=wrap)
    rays = rays_from_numpy(e, d, h, device="cpu")
    params = tf_params_from_numpy(**_as_numpy(pj), device="cpu")
    rgb, a = render_tf(params, torch.tensor(vol), rays.entry_uv, rays.direction, rays.hit,
                       MAX_SAMPLES, wrap)
    assert rgb.shape == (16, 16, 3) and a.shape == (16, 16)
    assert float(a.max()) > 0.5
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-6, rtol=0)


def test_tf_loss_matches_jax():
    vol, (e, d, h) = _scene()
    pj = _jax_params()
    target = np.random.default_rng(11).random((16, 16, 3)).astype(np.float32)
    loss_j = tf_loss_jax(pj, jnp.asarray(vol), e, d, h, jnp.asarray(target),
                         max_samples=MAX_SAMPLES)
    rays = rays_from_numpy(e, d, h, device="cpu")
    params = tf_params_from_numpy(**_as_numpy(pj), device="cpu")
    loss = tf_loss(params, torch.tensor(vol), rays.entry_uv, rays.direction, rays.hit,
                   torch.tensor(target), MAX_SAMPLES)
    assert loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)


def test_autograd_gradients_match_jax_grad():
    """Torch autograd through the loop vs ``jax.grad`` through the scan, for
    every TF parameter and every voxel, with general cotangents on both
    outputs."""
    vol, (e, d, h) = _scene()
    pj = _jax_params()
    rng = np.random.default_rng(4)
    w_rgb = rng.standard_normal((16, 16, 3)).astype(np.float32)
    w_a = rng.standard_normal((16, 16)).astype(np.float32)

    def loss_j(p, v):
        rgb, a = render_tf_jax(p, v, e, d, h, max_samples=MAX_SAMPLES)
        return jnp.sum(rgb * w_rgb) + jnp.sum(a * w_a)

    gp_j, gv_j = jax.grad(loss_j, argnums=(0, 1))(pj, jnp.asarray(vol))

    rays = rays_from_numpy(e, d, h, device="cpu")
    params = TFParams(*(t.requires_grad_(True)
                        for t in tf_params_from_numpy(**_as_numpy(pj), device="cpu")))
    vt = torch.tensor(vol, requires_grad=True)
    rgb, a = render_tf(params, vt, rays.entry_uv, rays.direction, rays.hit, MAX_SAMPLES)
    loss = torch.sum(rgb * torch.tensor(w_rgb)) + torch.sum(a * torch.tensor(w_a))
    *gp, gv = torch.autograd.grad(loss, [*params, vt])
    for name, g_t, g_j in zip(TFParams._fields, gp, gp_j):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=2e-3, atol=1e-5,
                                   err_msg=name)
    assert float(np.abs(np.asarray(gv_j)).max()) > 0.1
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_j), rtol=5e-3, atol=1e-4)


def test_tf_params_from_numpy_round_trips():
    pj = _jax_params()
    fields = _as_numpy(pj)
    pt = tf_params_from_numpy(**fields, device="cpu")
    assert isinstance(pt, TFParams) and pt._fields == JTFParams._fields
    for name in TFParams._fields:
        got = getattr(pt, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), fields[name])
    ref = tf_params_from_numpy(**_as_numpy(JTFParams.reference()), device="cpu")
    for a, b in zip(ref, TFParams.reference(device="cpu")):
        assert torch.equal(a, b)


@pytest.mark.parametrize("edit,err", [
    (lambda f: f.pop("flip_bias"), TypeError),
    (lambda f: f.update(gain=np.float32(1.0)), TypeError),
    (lambda f: f.update(flip_sign=np.zeros(2, np.float32)), ValueError),
    (lambda f: f.update(alpha_scale=np.zeros(1, np.float32)), ValueError),
])
def test_tf_params_from_numpy_rejects_bad_fields(edit, err):
    fields = _as_numpy(_jax_params())
    edit(fields)
    with pytest.raises(err):
        tf_params_from_numpy(**fields, device="cpu")
