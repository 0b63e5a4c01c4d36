"""Differentiable ray march with a learnable transfer function (PyTorch).

Counterpart of ``volumerenderer_tpu/diff/transfer.py``.  The reference shader
hardcodes its transfer function (the ``* 0.6`` alpha factor and the final
channel flips); here those constants are learnable parameters, so the render
is differentiable end to end with respect to the TF parameters *and* the
voxels.  At ``TFParams.reference()`` the output equals the reference render.

``render_tf`` is written as separate tensor operations in the JAX function's
order (no fused multiply-add, no ``lerp``) and is differentiable through plain
torch autograd: the indexing in ``ops/sampling.py`` has a backward.  That
autograd is the scan-autodiff reference the O(1) VJP (``diff/vjp.py``) and the
gradient kernels are held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.raycast import EARLY_OUT_ALPHA, MAX_SAMPLES, step_sizes
from ..ops.sampling import sample_trilinear

__all__ = ["TFParams", "render_tf", "tf_loss"]


class TFParams(NamedTuple):
    """Learnable transfer-function parameters, each a float32 tensor."""

    alpha_scale: torch.Tensor   # 0-d, reference value 0.6
    color_gain: torch.Tensor    # 0-d gain on the per-sample color
    color_bias: torch.Tensor    # 0-d bias on the per-sample color
    flip_sign: torch.Tensor     # (3,) final-transfer slope per channel
    flip_bias: torch.Tensor     # (3,) final-transfer intercept per channel

    @classmethod
    def reference(cls, device: torch.device | str = "cuda") -> "TFParams":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(alpha_scale=f32(0.6), color_gain=f32(1.0), color_bias=f32(0.0),
                   flip_sign=f32([-1.0, -1.0, 0.0]), flip_bias=f32([1.0, 1.0, 1.0]))


def render_tf(params: TFParams, volume: torch.Tensor, entry_uv: torch.Tensor,
              direction: torch.Tensor, hit: torch.Tensor, max_samples: int = MAX_SAMPLES,
              wrap: str = "clamp"):
    """Differentiable compositing march.  Returns (rgb (..., 3), alpha (...)).

    The control flow of ``ops.raycast.composite_march`` with the TF
    parameters spliced in: positions advance by repeated ``pos + dir_step``,
    ``sc = s*G + B``, ``pa = s - s*a``, ``c += pa*sc``, ``a += pa*K``, and a
    ray stops at the bounds exit or once ``a > 0.99``.  The loop ends early
    once every ray has stopped; a stopped ray never changes again, so the
    result and its gradients are those of the full ``max_samples`` steps.
    """
    Z, Y, X = volume.shape
    dir_step = direction * step_sizes((X, Y, Z), direction.device)
    shape = entry_uv.shape[:-1]
    pos = entry_uv
    color = torch.zeros(shape, dtype=torch.float32, device=entry_uv.device)
    alpha = torch.zeros(shape, dtype=torch.float32, device=entry_uv.device)
    alive = hit.to(torch.bool)
    for _ in range(max_samples):
        if not bool(alive.any()):
            break
        pos = pos + dir_step
        inside = ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
        alive = alive & inside
        s = sample_trilinear(volume, pos, wrap=wrap)
        sc = s * params.color_gain + params.color_bias
        prev_alpha = s - s * alpha
        color = torch.where(alive, color + prev_alpha * sc, color)
        alpha = torch.where(alive, alpha + prev_alpha * params.alpha_scale, alpha)
        alive = alive & (alpha <= EARLY_OUT_ALPHA)
    rgb = params.flip_sign * color[..., None] + params.flip_bias
    return rgb, alpha


def tf_loss(params: TFParams, volume, entry_uv, direction, hit, target_rgb,
            max_samples: int = MAX_SAMPLES, wrap: str = "clamp"):
    """Mean-squared pixel loss against a target image."""
    rgb, _ = render_tf(params, volume, entry_uv, direction, hit, max_samples, wrap)
    return torch.mean((rgb - target_rgb) ** 2)
