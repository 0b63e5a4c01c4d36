"""O(1)-memory VJP of the differentiable compositing march (PyTorch).

Counterpart of ``volumerenderer_tpu/diff/vjp.py``.  Autograd through
``render_tf``'s loop stores every step's state (hundreds of images at
1024²).  This ``torch.autograd.Function`` saves O(rays) instead, using two
facts of the compositing recurrence:

1. sample positions are analytic, ``pos_t = entry + (t+1) * step``, so the
   backward pass resamples the volume instead of storing samples;
2. the alpha recurrence ``a' = a(1 - ks) + ks`` is invertible, and alpha is
   nondecreasing, so the trajectory reconstructs backward from the final
   state; the latched early-out is recovered from the per-ray saturation step
   ``t_sat``, and the bounds mask is analytic.

Saved: final (color, alpha) and ``t_sat``.  Gradients flow to the TF
parameters (reductions) and to the voxels (scatter-add through the trilinear
weights, one scatter per step; cheap to skip with
``compute_volume_grad=False``).

The analytic positions are this function's semantics, as in its JAX
counterpart: they differ from ``render_tf``'s repeated addition by rounding,
so the two forwards agree to rounding, not bit for bit.  Clamp wrap only.
"""
from __future__ import annotations

import torch

from ..ops.raycast import EARLY_OUT_ALPHA, MAX_SAMPLES, step_sizes
from ..ops.sampling import sample_trilinear, trilinear_scatter_add_
from .transfer import TFParams

__all__ = ["render_tf_o1"]


def _inside(pos: torch.Tensor) -> torch.Tensor:
    return ((pos > 0.0) & (pos < 1.0)).all(dim=-1)


class _RenderTFO1(torch.autograd.Function):

    @staticmethod
    def forward(ctx, max_samples, compute_volume_grad, volume, entry_uv, direction, hit,
                *param_tensors):
        K, G, B, flip_sign, flip_bias = param_tensors
        Z, Y, X = volume.shape
        step = direction * step_sizes((X, Y, Z), direction.device)
        shape = entry_uv.shape[:-1]
        color = torch.zeros(shape, dtype=torch.float32, device=entry_uv.device)
        alpha = torch.zeros_like(color)
        alive = hit.to(torch.bool)
        t_sat = torch.full(shape, -1, dtype=torch.int32, device=entry_uv.device)
        for t in range(max_samples):
            pos = entry_uv + (t + 1.0) * step
            alive = alive & _inside(pos)
            s = sample_trilinear(volume, pos)
            sc = s * G + B
            pa = s - s * alpha
            color = torch.where(alive, color + pa * sc, color)
            alpha = torch.where(alive, alpha + pa * K, alpha)
            saturated = alpha > EARLY_OUT_ALPHA
            # the first step whose update pushed alpha over the threshold
            t_sat = torch.where(alive & saturated & (t_sat < 0), t, t_sat)
            alive = alive & ~saturated
        rgb = flip_sign * color[..., None] + flip_bias
        ctx.max_samples = max_samples
        ctx.compute_volume_grad = compute_volume_grad
        ctx.save_for_backward(volume, entry_uv, step, hit, color, alpha, t_sat, *param_tensors)
        return rgb, alpha

    @staticmethod
    def backward(ctx, g_rgb, g_alpha_out):
        volume, entry_uv, step, hit, color_T, alpha_T, t_sat, *param_tensors = ctx.saved_tensors
        k, G, B, flip_sign, _ = param_tensors
        max_samples = ctx.max_samples

        # final-transfer pullback: rgb = flip_sign * c + flip_bias
        gc = torch.sum(g_rgb * flip_sign, dim=-1)
        g_flip_sign = torch.sum(g_rgb * color_T[..., None], dim=tuple(range(g_rgb.dim() - 1)))
        g_flip_bias = torch.sum(g_rgb, dim=tuple(range(g_rgb.dim() - 1)))

        inside0 = _inside(entry_uv + 1.0 * step)
        hit = hit.to(torch.bool)
        want_volume = ctx.needs_input_grad[2]
        g_vol = torch.zeros_like(volume) if want_volume else None
        a_next = alpha_T
        ga = g_alpha_out
        gk = torch.zeros((), dtype=torch.float32, device=volume.device)
        gG = torch.zeros_like(gk)
        gB = torch.zeros_like(gk)
        for t in range(max_samples - 1, -1, -1):  # reverse order
            pos = entry_uv + (t + 1.0) * step
            # alive at step t: latched bounds (inside at the first step and at
            # step t implies inside at every step between: the cube is
            # convex), hit, and not yet saturated
            not_sat = (t_sat < 0) | (t <= t_sat)
            alive = hit & inside0 & _inside(pos) & not_sat
            s = sample_trilinear(volume, pos)
            sc = s * G + B
            # invert the recurrence where this step was active
            denom = 1.0 - k * s
            a_t = torch.where(alive, (a_next - k * s) / torch.clamp(denom, min=1e-12), a_next)
            pa = s - s * a_t

            # gradients of this step's update
            g_s = torch.where(alive, gc * ((1.0 - a_t) * sc + pa * G) + ga * k * (1.0 - a_t), 0.0)
            gG = gG + torch.sum(torch.where(alive, gc * pa * s, 0.0))
            gB = gB + torch.sum(torch.where(alive, gc * pa, 0.0))
            gk = gk + torch.sum(torch.where(alive, ga * pa, 0.0))
            ga = torch.where(alive, gc * (-s * sc) + ga * denom, ga)
            a_next = a_t

            # route g_s through the trilinear weights into the voxel grid
            if want_volume and ctx.compute_volume_grad:
                trilinear_scatter_add_(g_vol, pos[alive], g_s[alive])

        return (None, None, g_vol, None, None, None, gk, gG, gB, g_flip_sign, g_flip_bias)


def render_tf_o1(params: TFParams, volume: torch.Tensor, entry_uv: torch.Tensor,
                 direction: torch.Tensor, hit: torch.Tensor, max_samples: int = MAX_SAMPLES,
                 compute_volume_grad: bool = True):
    """Differentiable march with O(1) gradient memory.  Returns (rgb, alpha).

    The forward agrees with ``diff.transfer.render_tf`` to rounding (module
    docstring: analytic positions).  With ``compute_volume_grad=False`` the
    volume's gradient is zeros and the per-step scatter is skipped.  No
    gradient flows to ``entry_uv`` or ``direction``.
    """
    return _RenderTFO1.apply(int(max_samples), bool(compute_volume_grad), volume, entry_uv,
                             direction, hit, *params)
