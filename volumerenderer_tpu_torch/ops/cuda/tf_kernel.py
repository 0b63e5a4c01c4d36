"""Differentiable TF render on the GPU: the launch wrapper of
``csrc/tf_march.cu`` and the fit API around it.

Counterpart of ``volumerenderer_tpu/ops/pallas/tf_kernel.py``
(``render_tf_grads_pallas``, ``make_render_tf_kernel``, ``tf_fit_step_fast``).
One kernel pass gives the TF render AND every TF-parameter gradient sum
(``diff/closed_form.py``), so a fit step costs about one forward frame.  The
port has no word tables: the kernel reads the volume straight from device
memory, and the plan is the port's ``CompositingPlan``.

``tf_march_cuda`` takes a uint8 or a float32 volume and dispatches on where
its tensors lie: CUDA tensors launch the kernel, CPU tensors run the plain
PyTorch version (``diff/closed_form.py::tf_march_steps``).  There is no
fallback from one to the other: a CUDA input the kernel cannot take raises.
The march is clamp-only, as the TPU kernel (its plan admits only clamp
wrapping).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...diff.closed_form import (cotangent_images, tf_march_steps, tf_param_grads,
                                 tf_scalars as _tf_scalars)
from ...diff.transfer import TFParams
from ...utils.timer import span
from ..raycast import MAX_SAMPLES
from ..sampling import as_normalized_volume
from . import _build, _launch
from ._launch import (bind, check_hit, check_image, check_max_samples, check_tensors,
                      check_volume, count_launch, dense_entry, launch)
from .raycast_kernel import CompositingPlan, quantize_u8

__all__ = ["tf_march_cuda", "render_tf_grads_kernel", "make_render_tf_kernel",
           "tf_fit_step_fast", "load_kernel"]


@functools.cache
def _launcher(entry: str = "tf_march"):
    # entry_uv, dir_step, hit, vol, tf; H, W, X, Y, Z, max_samples; out, stream
    return bind("tf_march", 5, 6, [ctypes.c_void_p] * 2, entry=entry)


def load_kernel() -> _build.BuiltLibrary:
    """Build (at first use) and load the TF march kernel's library."""
    return _launcher()[1]


def check_clamp(wrap: str) -> None:
    """The gradient kernels and their plain versions are clamp-only."""
    _launch.check_clamp(wrap, "the TF and voxel-gradient marches")


def check_march_inputs(tensors: dict, max_samples, wrap, kernel: str) -> str:
    """The checks shared by both gradient kernels' wrappers: ``tensors``
    holds the volume (uint8 or float32), entry_uv, dir_step, hit and
    tf_scalars (and may hold more).  Returns the C entry of ``kernel`` for
    the volume's dtype."""
    check_tensors(tensors, "volume")
    volume = tensors["volume"]
    entry = dense_entry(kernel, volume)
    check_volume(volume, volume.dtype, "volume")
    hit = tensors["hit"]
    check_hit(hit)
    check_image(tensors, hit.shape, torch.float32, ("entry_uv", "dir_step"), (3,))
    check_image(tensors, (), torch.float32, ("tf_scalars",), (3,))
    check_max_samples(max_samples)
    check_clamp(wrap)
    return entry


def tf_march_cuda(volume: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                  hit: torch.Tensor, tf_scalars: torch.Tensor, max_samples: int = MAX_SAMPLES,
                  wrap: str = "clamp"):
    """The TF compositing march with its gradient sums, one pass (B4).

    Args:
      volume: (Z, Y, X) volume, x fastest: uint8, read as its bytes, or
        float32, whose taps the kernel quantizes to 8 bits as it reads them
        (the images are the byte route's on ``quantize_u8(volume)``, bit for
        bit, with no quantize pass and no byte copy); any other dtype
        raises ValueError.
      entry_uv: (H, W, 3) float32 cube entry points in texture space.
      dir_step: (H, W, 3) float32 per-step increment (direction / dims).
      hit: (H, W) uint8, nonzero where the ray enters the cube.
      tf_scalars: (3,) float32 (alpha_scale, color_gain, color_bias), on the
        volume's device.
      wrap: "clamp" only; "repeat" raises ValueError.

    Returns the seven (H, W) float32 images (color_T, alpha_T, R, P_total,
    QP, SG, SB).  CUDA tensors run the kernel and add one to
    ``tf_march_cuda.launches`` (and, for a float32 volume, to its
    ``f32_launches``); CPU tensors run the plain version on
    ``quantize_u8(volume)``.
    """
    tensors = {"volume": volume, "entry_uv": entry_uv, "dir_step": dir_step, "hit": hit,
               "tf_scalars": tf_scalars}
    entry = check_march_inputs(tensors, max_samples, wrap, "tf_march")
    if volume.device.type == "cpu":
        return tf_march_steps(as_normalized_volume(quantize_u8(volume)), entry_uv, dir_step,
                              hit.to(torch.bool), tf_scalars, max_samples)
    H, W = hit.shape
    Z, Y, X = volume.shape
    out = torch.empty((7, H, W), dtype=torch.float32, device=volume.device)
    if H * W > 0:
        launch(lambda: _launcher(entry), "tf_march", volume.device,
               entry_uv.data_ptr(), dir_step.data_ptr(), hit.data_ptr(), volume.data_ptr(),
               tf_scalars.data_ptr(), H, W, X, Y, Z, max_samples, out.data_ptr())
        count_launch(tf_march_cuda, volume)
    return tuple(out.unbind(0))


tf_march_cuda.launches = 0
tf_march_cuda.f32_launches = 0


def check_plan(plan: CompositingPlan) -> None:
    """A plan the gradient kernels can serve: a clamp-wrapped one."""
    if not isinstance(plan, CompositingPlan):
        raise TypeError(f"plan must be a CompositingPlan, got {type(plan).__name__}")
    check_clamp(plan.wrap)


def _march(params: TFParams, volume: torch.Tensor, plan: CompositingPlan):
    with span("vr.tf.march"):
        # the kernel reads the volume in place: a view (a slice of a larger
        # volume) is copied, a contiguous volume is not
        volume = volume.contiguous()
        partials = tf_march_cuda(volume, plan.entry_uv, plan.dir_step, plan.hit,
                                 _tf_scalars(params), plan.max_samples, plan.wrap)
        rgb = params.flip_sign * partials[0][..., None] + params.flip_bias
        return rgb, partials[1], partials


def render_tf_grads_kernel(params: TFParams, volume: torch.Tensor, plan: CompositingPlan):
    """One kernel pass -> (rgb (H, W, 3), alpha (H, W), partials) where
    ``partials`` = (color_T, alpha_T, R, P_total, QP, SG, SB) as (H, W)
    images.  ``volume`` is (Z, Y, X) on the plan's device: float32 in [0, 1],
    whose taps the kernel quantizes to 8 bits as it reads them (as the TPU
    kernel quantizes the volume; no quantize pass), or uint8."""
    check_plan(plan)
    plan.check_volume(volume)
    return _march(params, volume, plan)


class _RenderTF(torch.autograd.Function):
    """f(params, volume) -> (rgb, alpha) through the TF march kernel; the
    backward forms the TF gradients from the forward's partials and asks
    ``volume_grad`` for the volume's.  The forward makes no byte copy of the
    volume, and keeps the volume only when its gradient is asked for."""

    @staticmethod
    def forward(ctx, plan, volume_grad, volume, *param_tensors):
        plan.check_volume(volume)
        params = TFParams(*param_tensors)
        rgb, alpha, partials = _march(params, volume, plan)
        ctx.set_materialize_grads(False)
        ctx.plan = plan
        ctx.volume_grad = volume_grad
        ctx.save_for_backward(volume if ctx.needs_input_grad[2] else None, *param_tensors,
                              *partials)
        return rgb, alpha

    @staticmethod
    def backward(ctx, g_rgb, g_alpha):
        volume, *saved = ctx.saved_tensors
        params = TFParams(*saved[:5])
        partials = saved[5:]
        gc, gaT_term = cotangent_images(params, g_rgb, g_alpha, partials[1])
        g_params = tf_param_grads(params, partials, g_rgb, gc, gaT_term)
        g_vol = None
        if ctx.needs_input_grad[2]:
            g_vol = ctx.volume_grad(params, volume, ctx.plan, gc, gaT_term, partials[3])
        return (None, None, g_vol, *g_params)


def bind_render_tf(plan: CompositingPlan, volume_grad):
    """``f(params, volume) -> (rgb, alpha)`` bound to ``plan``, differentiable
    with respect to the TF parameters and the volume.  ``volume_grad(params,
    volume, plan, gc, gaT_term, P_tot)`` gives the volume's gradient; it is
    called only when that gradient is asked for."""
    check_plan(plan)

    def f(params: TFParams, volume: torch.Tensor):
        return _RenderTF.apply(plan, volume_grad, volume, *params)

    return f


def _zero_volume_grad(params, volume, plan, gc, gaT_term, P_tot):
    return torch.zeros(volume.shape, dtype=torch.float32, device=volume.device)


def make_render_tf_kernel(plan: CompositingPlan):
    """A differentiable ``f(params, volume) -> (rgb, alpha)`` bound to a
    ``CompositingPlan`` (plan once, fit many): the forward is one kernel
    pass, and the TF-parameter gradients come from that same pass (the
    closed-form adjoint), so a gradient step costs about one forward frame.
    The volume's gradient is zeros by construction (a constant volume; use
    ``make_render_tf_voxel`` when optimizing voxels).  A ``None`` cotangent
    counts as zero.  Raises ValueError for a plan whose wrap is not clamp."""
    return bind_render_tf(plan, _zero_volume_grad)


def tf_fit_step_fast(f, params: TFParams, volume: torch.Tensor, target_rgb: torch.Tensor,
                     lr: float = 1e-2):
    """One SGD step of the TF fit on the kernel path: ``f`` from
    :func:`make_render_tf_kernel`.  Returns (new_params, loss), both on the
    device; nothing is read on the host."""
    leaves = TFParams(*(p.detach().requires_grad_(True) for p in params))
    rgb, _ = f(leaves, volume)
    loss = torch.mean((rgb - target_rgb) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    new_params = TFParams(*(p.detach() - lr * g for p, g in zip(params, grads)))
    return new_params, loss.detach()
