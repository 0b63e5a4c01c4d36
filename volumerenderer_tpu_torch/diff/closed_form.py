"""The closed-form adjoint of the TF compositing march, in plain PyTorch: the
plain versions of the TF-gradient march (``csrc/tf_march.cu``) and the
voxel-gradient march (``csrc/voxel_grad.cu``), and the reductions around them.

The derivation is the JAX package's (``ops/pallas/tf_kernel.py`` module
docstring).  With TF parameters K = alpha_scale, G = color_gain,
B = color_bias and ``sc = s*G + B``, the adjoint ``ga_t`` of alpha obeys a
linear backward recurrence that transmittance ``1 - a_{t+1} = (1 - a_t)(1 -
K s_t)`` solves with forward prefix sums, so one forward march yields every
TF gradient:

    P_t = sum_{u<=t} s_u sc_u (1 - a_u)        (pre-update alpha)
    r_t = s_t / (1 - K s_t)
    dK  = sum gaT (1 - a_T) R - gc (P_total R - QP),  R = sum r_t,  QP = sum r_t P_t
    dG  = sum gc SG,  SG = sum pa_t s_t
    dB  = sum gc SB,  SB = sum pa_t

and a second forward march yields each step's sample cotangent

    g_s(t) = gc ((1 - a_t) sc_t + pa_t G) + K (gaT (1 - a_T) - gc (P_total - P_t)) / (1 - K s_t)

which the trilinear adjoint scatters into the voxels.  Each march is written
as separate tensor operations in the kernel's order, so the kernels can be
held to them bit for bit (B4) or to the order of their atomic sums (B5).
``seg_tf_march_steps`` is the TF march with its sums on one shard of a
volume-sharded layout (the plain version of ``csrc/seg_march.cu``'s B11),
with the shard's local alpha; ``ops/cuda/seg_kernel.py::compose_tf_segments``
folds the shards' sums into the global ones.  These functions are what the
kernel wrappers run on CPU tensors and what ``chip_smoke.py`` holds the
kernels against on the card.  Clamp wrap only,
as the kernels.
"""
from __future__ import annotations

import torch

from ..ops.raycast import BIG_T, EARLY_OUT_ALPHA, MAX_SAMPLES, seg_steps
from ..ops.sampling import as_sampler, sample_trilinear, trilinear_scatter_add_
from .transfer import TFParams

__all__ = ["tf_scalars", "tf_march_steps", "seg_tf_march_steps", "step_cotangents",
           "voxel_grad_steps", "cotangent_images", "tf_param_grads"]


def tf_scalars(params: TFParams) -> torch.Tensor:
    """(K, G, B) as one (3,) float32 tensor on the parameters' device, the
    form the kernels read (no host read of the values)."""
    return torch.stack([params.alpha_scale, params.color_gain,
                        params.color_bias]).to(torch.float32).contiguous()


def _inside(pos: torch.Tensor) -> torch.Tensor:
    return ((pos > 0.0) & (pos < 1.0)).all(dim=-1)


def tf_march_steps(volume: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                   hit: torch.Tensor, tf_scalars: torch.Tensor, max_samples: int = MAX_SAMPLES):
    """The TF compositing march and its gradient sums in one pass.

    Args:
      volume: (Z, Y, X) float32 in [0, 1].
      entry_uv, dir_step: (H, W, 3) float32; positions advance by repeated
        ``pos + dir_step``.
      hit: (H, W) bool.
      tf_scalars: (3,) float32 (K, G, B).

    Returns the seven (H, W) float32 images (color_T, alpha_T, R, P_total,
    QP, SG, SB).
    """
    K, G, B = tf_scalars[0], tf_scalars[1], tf_scalars[2]
    color, alpha, R, P, QP, SG, SB = (
        torch.zeros(entry_uv.shape[:-1], dtype=torch.float32, device=entry_uv.device)
        for _ in range(7))
    pos = entry_uv
    alive = hit.to(torch.bool)
    for _ in range(max_samples):
        if not bool(alive.any()):
            break
        pos = pos + dir_step
        alive = alive & _inside(pos)
        s = sample_trilinear(volume, pos)
        sc = s * G + B
        pa = s - s * alpha
        r = s / torch.clamp(1.0 - K * s, min=1e-12)
        # P with the pre-update alpha, then QP against the inclusive P
        P = P + torch.where(alive, s * sc * (1.0 - alpha), 0.0)
        R = R + torch.where(alive, r, 0.0)
        QP = QP + torch.where(alive, r * P, 0.0)
        SG = SG + torch.where(alive, pa * s, 0.0)
        SB = SB + torch.where(alive, pa, 0.0)
        color = torch.where(alive, color + pa * sc, color)
        alpha = torch.where(alive, alpha + pa * K, alpha)
        alive = alive & (alpha <= EARLY_OUT_ALPHA)
    return color, alpha, R, P, QP, SG, SB


def seg_tf_march_steps(volume, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                       hit: torch.Tensor, tf_scalars: torch.Tensor, dims, box,
                       max_samples: int = MAX_SAMPLES, starts: torch.Tensor | None = None):
    """:func:`tf_march_steps` on one volume shard, as
    ``ops/raycast.py::seg_march_steps`` marches one: ``volume`` a sampler of
    the global volume (``shard_sampler``) or a float32 volume, ``dims`` (X,
    Y, Z), ``box`` the owned anchor box; only owned samples of alive rays
    composite and add to the sums, with the shard's local alpha, and there
    is no early-out.  With ``starts`` (the entry of
    ``ops/raycast.py::seg_entry_table``) each ray starts at its first owned
    step, with the same result (``ops/raycast.py::seg_steps``).

    Returns the eight (H, W) float32 images (C_seg, alpha_seg, t_first, R, P,
    QP, SG, SB), the fields of the JAX ``launch_seg_tf`` in its order.
    """
    K, G, B = tf_scalars[0], tf_scalars[1], tf_scalars[2]
    color, alpha, R, P, QP, SG, SB = (
        torch.zeros(entry_uv.shape[:-1], dtype=torch.float32, device=entry_uv.device)
        for _ in range(7))
    t_first = torch.full_like(color, BIG_T)
    sample = as_sampler(volume)
    for pos, comp, t in seg_steps(entry_uv, dir_step, hit, dims, box, max_samples, starts):
        s = sample(pos)
        sc = s * G + B
        pa = s - s * alpha
        r = s / torch.clamp(1.0 - K * s, min=1e-12)
        P = P + torch.where(comp, s * sc * (1.0 - alpha), 0.0)
        R = R + torch.where(comp, r, 0.0)
        QP = QP + torch.where(comp, r * P, 0.0)
        SG = SG + torch.where(comp, pa * s, 0.0)
        SB = SB + torch.where(comp, pa, 0.0)
        color = torch.where(comp, color + pa * sc, color)
        alpha = torch.where(comp, alpha + pa * K, alpha)
        t_first = torch.where(comp, torch.clamp(t_first, max=t), t_first)
    return color, alpha, t_first, R, P, QP, SG, SB


def step_cotangents(volume: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                    hit: torch.Tensor, tf_scalars: torch.Tensor, gc: torch.Tensor,
                    gaT_term: torch.Tensor, P_tot: torch.Tensor,
                    max_samples: int = MAX_SAMPLES):
    """Replays the march of :func:`tf_march_steps` and yields, for each step,
    the positions of the rays alive at it and their sample cotangents g_s
    (module docstring): two (N, 3) and (N,) float32 tensors.  ``gc``,
    ``gaT_term = g_alpha (1 - alpha_T)`` and ``P_tot`` are (H, W) float32."""
    K, G, B = tf_scalars[0], tf_scalars[1], tf_scalars[2]
    alpha = torch.zeros(entry_uv.shape[:-1], dtype=torch.float32, device=entry_uv.device)
    P = torch.zeros_like(alpha)
    pos = entry_uv
    alive = hit.to(torch.bool)
    for _ in range(max_samples):
        if not bool(alive.any()):
            break
        pos = pos + dir_step
        alive = alive & _inside(pos)
        s = sample_trilinear(volume, pos)
        sc = s * G + B
        pa = s - s * alpha
        P = P + torch.where(alive, s * sc * (1.0 - alpha), 0.0)
        denom = torch.clamp(1.0 - K * s, min=1e-12)
        # ga_{t+1} K (1 - a_t) = K N / (1 - K s_t): the (1 - a_t) factor
        # cancels against 1/(1 - a_{t+1}) = 1/((1 - a_t)(1 - K s_t))
        ga_term = K * (gaT_term - gc * (P_tot - P)) / denom
        g_s = gc * ((1.0 - alpha) * sc + pa * G) + ga_term
        yield pos[alive], g_s[alive]
        alpha = torch.where(alive, alpha + pa * K, alpha)
        alive = alive & (alpha <= EARLY_OUT_ALPHA)


def voxel_grad_steps(volume: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                     hit: torch.Tensor, tf_scalars: torch.Tensor, gc: torch.Tensor,
                     gaT_term: torch.Tensor, P_tot: torch.Tensor,
                     max_samples: int = MAX_SAMPLES) -> torch.Tensor:
    """dL/dvolume: every alive step's g_s, even at s = 0, scattered through
    the clamp-mode trilinear adjoint.  Returns (Z, Y, X) float32.  The
    volume is the 8-bit grid's float image, so the gradient is the one of
    the float volume straight through the quantization."""
    g_vol = torch.zeros(volume.shape, dtype=torch.float32, device=volume.device)
    for pos, g_s in step_cotangents(volume, entry_uv, dir_step, hit, tf_scalars, gc, gaT_term,
                                    P_tot, max_samples):
        trilinear_scatter_add_(g_vol, pos, g_s)
    return g_vol


def cotangent_images(params: TFParams, g_rgb, g_alpha, alpha_T: torch.Tensor):
    """The per-ray cotangents the backward passes read: ``gc = sum_c g_rgb
    flip_sign`` and ``gaT_term = g_alpha (1 - alpha_T)``, each (H, W).  A
    ``None`` cotangent counts as zero."""
    gc = (torch.zeros_like(alpha_T) if g_rgb is None
          else torch.sum(g_rgb * params.flip_sign, dim=-1))
    gaT_term = torch.zeros_like(alpha_T) if g_alpha is None else g_alpha * (1.0 - alpha_T)
    return gc, gaT_term


def tf_param_grads(params: TFParams, partials, g_rgb, gc: torch.Tensor,
                   gaT_term: torch.Tensor) -> TFParams:
    """The TF parameters' gradients from the seven images of
    :func:`tf_march_steps` and the cotangents (``g_rgb`` may be ``None``)."""
    color_T, _, R, P_tot, QP, SG, SB = partials
    gk = torch.sum(gaT_term * R - gc * (P_tot * R - QP))
    gG = torch.sum(gc * SG)
    gB = torch.sum(gc * SB)
    if g_rgb is None:
        g_flip_sign = torch.zeros_like(params.flip_sign)
        g_flip_bias = torch.zeros_like(params.flip_bias)
    else:
        dims = tuple(range(g_rgb.dim() - 1))
        g_flip_sign = torch.sum(g_rgb * color_T[..., None], dim=dims)
        g_flip_bias = torch.sum(g_rgb, dim=dims)
    return TFParams(alpha_scale=gk, color_gain=gG, color_bias=gB,
                    flip_sign=g_flip_sign, flip_bias=g_flip_bias)
