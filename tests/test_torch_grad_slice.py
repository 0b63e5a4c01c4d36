"""The whole gradient slice of the port against the same chain in JAX.

The port's chain — ``Camera`` -> ``generate_rays`` -> ``plan_compositing`` ->
``make_render_tf_voxel`` -> MSE loss -> gradients of the TF params and the
volume -> one SGD step on both — is held against JAX's ``generate_rays`` ->
``render_tf_o1`` -> the same loss -> ``jax.grad`` -> the same step, each on
its own rays, on a 16³ turbulence volume at 32x24.  Bars: the gradients'
(test_pallas_interpret.py:417-427, 2e-4 relative), carried through the step:
new params within rtol 2e-4 / atol 2e-4 * lr * max(1, |g|), new volume within
2e-4 * lr * max(1, max |g_vol|).  The config-4 fit (5 steps at lr 0.05,
target 0.5) follows JAX's losses within 1e-5 relative and lowers the loss.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderer_tpu as J
from volumerenderer_tpu.diff.transfer import TFParams as JTFParams
from volumerenderer_tpu.diff.transfer import render_tf as render_tf_jax
from volumerenderer_tpu.diff.vjp import render_tf_o1 as render_tf_o1_jax
from volumerenderer_tpu.io.synthetic import turbulence_volume as turbulence_volume_jax
from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.models import plan_compositing
from volumerenderer_tpu_torch.ops.cuda.tf_kernel import make_render_tf_kernel, tf_fit_step_fast
from volumerenderer_tpu_torch.ops.cuda.voxel_grad_kernel import make_render_tf_voxel

W, H = 32, 24
LR = 0.05
MAX_SAMPLES = 64


def _camera(az_deg, camera_cls):
    if az_deg is None:
        return camera_cls(width=W, height=H)
    a = math.radians(az_deg)
    return camera_cls(width=W, height=H,
                      position=(0.75 * math.sin(a), 0.0, -0.75 * math.cos(a)),
                      front=(-math.sin(a), 0.0, math.cos(a)))


@pytest.mark.parametrize("az_deg", [None, 30.0])
def test_voxel_grad_step_matches_jax_chain(az_deg):
    vol_u8 = turbulence_volume((16, 16, 16), seed=8)
    target = np.full((H, W, 3), 0.5, np.float32)

    # JAX: rays -> render_tf_o1 -> loss -> grads -> SGD
    rays_j = J.generate_rays(_camera(az_deg, J.Camera))
    vol_j = J.as_normalized_volume(turbulence_volume_jax((16, 16, 16), seed=8))

    def loss_j(p, v):
        rgb, _ = render_tf_o1_jax(p, v, rays_j.entry_uv, rays_j.direction, rays_j.hit,
                                  MAX_SAMPLES, True)
        return jnp.mean((rgb - target) ** 2)

    p_j = JTFParams.reference()
    gp_j, gv_j = jax.grad(loss_j, argnums=(0, 1))(p_j, vol_j)
    new_p_j = jax.tree.map(lambda p, g: p - LR * g, p_j, gp_j)
    new_v_j = np.asarray(vol_j - LR * gv_j)

    # the port: rays -> plan -> make_render_tf_voxel -> loss -> grads -> SGD
    rays = generate_rays(_camera(az_deg, Camera), device="cpu")
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (16, 16, 16), MAX_SAMPLES)
    f = make_render_tf_voxel(plan)
    params = TFParams(*(t.requires_grad_(True) for t in TFParams.reference(device="cpu")))
    vol = as_normalized_volume(vol_u8, device="cpu").requires_grad_(True)
    rgb, _ = f(params, vol)
    loss = torch.mean((rgb - torch.tensor(target)) ** 2)
    *gp, gv = torch.autograd.grad(loss, [*params, vol])
    with torch.no_grad():
        new_params = TFParams(*(p - LR * g for p, g in zip(params, gp)))
        new_vol = vol - LR * gv

    assert np.isfinite(float(loss.detach())) and float(np.abs(np.asarray(gv_j)).max()) > 1e-3
    for name, n_t in zip(TFParams._fields, new_params):
        g_ref = np.asarray(getattr(gp_j, name))
        np.testing.assert_allclose(n_t.numpy(), np.asarray(getattr(new_p_j, name)), rtol=2e-4,
                                   atol=2e-4 * LR * max(1.0, np.abs(g_ref).max()), err_msg=name)
    scale = max(1.0, float(np.abs(np.asarray(gv_j)).max()))
    assert new_vol.shape == (16, 16, 16) and torch.isfinite(new_vol).all()
    np.testing.assert_allclose(new_vol.numpy(), new_v_j, rtol=0, atol=2e-4 * LR * scale)


def test_tf_fit_follows_jax_and_lowers_the_loss():
    """Config 4 of scripts/run_configs.py at a small size: five
    ``tf_fit_step_fast`` steps at lr 0.05 against a 0.5 target."""
    from volumerenderer_tpu.ops.pallas.tf_kernel import tf_fit_step_fast as step_jax

    vol_u8 = turbulence_volume((16, 16, 16), seed=8)
    rays_j = J.generate_rays(_camera(None, J.Camera))
    vol_j = J.as_normalized_volume(turbulence_volume_jax((16, 16, 16), seed=8))
    target_j = jnp.full((H, W, 3), 0.5, jnp.float32)

    def f_j(p, v):
        return render_tf_jax(p, v, rays_j.entry_uv, rays_j.direction, rays_j.hit,
                             max_samples=MAX_SAMPLES)

    rays = generate_rays(_camera(None, Camera), device="cpu")
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (16, 16, 16), MAX_SAMPLES)
    f = make_render_tf_kernel(plan)
    vol = as_normalized_volume(vol_u8, device="cpu")
    target = torch.full((H, W, 3), 0.5)
    p_j, params = JTFParams.reference(), TFParams.reference(device="cpu")
    losses_j, losses = [], []
    for _ in range(5):
        p_j, loss_j = step_jax(f_j, p_j, vol_j, target_j, lr=LR)
        params, loss = tf_fit_step_fast(f, params, vol, target, lr=LR)
        losses_j.append(float(loss_j))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    assert losses[-1] < losses[0]
