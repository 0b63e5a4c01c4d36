"""Voxel gradients on the GPU: the launch wrapper of ``csrc/voxel_grad.cu``
and the differentiable render with TF *and* voxel gradients.

Counterpart of ``volumerenderer_tpu/ops/pallas/voxel_grad_kernel.py``
(``voxel_grad_pallas``, ``make_render_tf_voxel``).  The backward is one
forward-order replay of the march per frame: the closed-form step cotangent
(``diff/closed_form.py``) scattered by the trilinear adjoint, with no reverse
march and no stored trajectory.  Every alive step scatters, even over empty
voxels: a zero voxel still has a nonzero gradient.  ``pack_cot_rows`` is not
ported: it packs the per-ray cotangents into TPU lane rows, and the CUDA
kernel reads them as (H, W) images.

``voxel_grad_cuda`` dispatches on where its tensors lie: CUDA tensors launch
the kernel, CPU tensors run the plain PyTorch version
(``diff/closed_form.py::voxel_grad_steps``).  There is no fallback from one
to the other: a CUDA input the kernel cannot take raises.  Clamp-only.  It
takes the volume as uint8 or as float32, and the kernel reads a float32
volume in place, quantizing each tap to 8 bits as it reads it, bit for bit
the byte route on ``quantize_u8(volume)`` (as B4 and B1 do): the fit's
backward makes no byte copy of the volume on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...diff.closed_form import cotangent_images, tf_scalars as _tf_scalars, voxel_grad_steps
from ...diff.transfer import TFParams
from ...utils.timer import span
from ..raycast import MAX_SAMPLES
from ..sampling import as_normalized_volume
from . import _build
from ._launch import bind, check_image, count_launch, dense_entry, launch
from .raycast_kernel import CompositingPlan, quantize_u8
from .tf_kernel import bind_render_tf, check_march_inputs, check_plan

__all__ = ["voxel_grad_cuda", "voxel_grad_block_stats", "voxel_grad_kernel",
           "make_render_tf_voxel", "load_kernel"]


@functools.cache
def _launcher(entry: str = "voxel_grad"):
    # entry_uv, dir_step, hit, vol, tf, gc, gaT_term, P_tot; H, W, X, Y, Z, max_samples;
    # g_vol, stats, stream
    return bind("voxel_grad", 8, 6, [ctypes.c_void_p] * 3, entry=entry)


def load_kernel() -> _build.BuiltLibrary:
    """Build (at first use) and load the voxel-gradient kernel's library."""
    return _launcher()[1]


def voxel_grad_cuda(volume: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                    hit: torch.Tensor, tf_scalars: torch.Tensor, gc: torch.Tensor,
                    gaT_term: torch.Tensor, P_tot: torch.Tensor,
                    max_samples: int = MAX_SAMPLES, wrap: str = "clamp") -> torch.Tensor:
    """dL/dvolume of one rendered frame.

    Args:
      volume: (Z, Y, X) uint8 volume, or float32, whose taps the kernel
        quantizes to 8 bits as it reads them (the gradient is then the byte
        route's on ``quantize_u8(volume)``, with no byte copy made); any
        other dtype raises ValueError.
      entry_uv, dir_step, hit, tf_scalars, max_samples: as for
        ``tf_kernel.tf_march_cuda``.
      gc: (H, W) float32, ``sum_c g_rgb * flip_sign``.
      gaT_term: (H, W) float32, ``g_alpha * (1 - alpha_T)``.
      P_tot: (H, W) float32, the forward pass's P_total.
      wrap: "clamp" only; "repeat" raises ValueError.

    Returns (Z, Y, X) float32, the gradient of the float volume straight
    through the 8-bit quantization.  CUDA tensors zero-fill it and run the
    kernel, adding one to ``voxel_grad_cuda.launches`` (and, for a float32
    volume, to ``voxel_grad_cuda.f32_launches``); CPU tensors run the plain
    version on ``as_normalized_volume(quantize_u8(volume))``.
    """
    tensors = _checked_inputs(volume, entry_uv, dir_step, hit, tf_scalars, gc, gaT_term, P_tot,
                              max_samples, wrap)
    if volume.device.type == "cpu":
        return voxel_grad_steps(as_normalized_volume(quantize_u8(volume)), entry_uv, dir_step,
                                hit.to(torch.bool), tf_scalars, gc, gaT_term, P_tot, max_samples)
    g_vol = torch.zeros(volume.shape, dtype=torch.float32, device=volume.device)
    if hit.numel() > 0:
        _launch_vg(tensors, max_samples, g_vol, None)
    return g_vol


voxel_grad_cuda.launches = 0
voxel_grad_cuda.f32_launches = 0


def _checked_inputs(volume, entry_uv, dir_step, hit, tf_scalars, gc, gaT_term, P_tot,
                    max_samples, wrap) -> dict:
    """The wrapper's inputs by name, checked: the volume uint8 or float32,
    any other dtype raises."""
    tensors = {"volume": volume, "entry_uv": entry_uv, "dir_step": dir_step, "hit": hit,
               "tf_scalars": tf_scalars, "gc": gc, "gaT_term": gaT_term, "P_tot": P_tot}
    check_march_inputs(tensors, max_samples, wrap, "voxel_grad")
    check_image(tensors, hit.shape, torch.float32, ("gc", "gaT_term", "P_tot"))
    return tensors


def _launch_vg(tensors: dict, max_samples: int, g_vol: torch.Tensor,
               stats: torch.Tensor | None) -> None:
    H, W = tensors["hit"].shape
    volume = tensors["volume"]
    Z, Y, X = volume.shape
    entry = dense_entry("voxel_grad", volume)
    launch(lambda: _launcher(entry), "voxel_grad", g_vol.device,
           *(tensors[n].data_ptr() for n in ("entry_uv", "dir_step", "hit", "volume",
                                              "tf_scalars", "gc", "gaT_term", "P_tot")),
           H, W, X, Y, Z, max_samples, g_vol.data_ptr(),
           None if stats is None else stats.data_ptr())
    count_launch(voxel_grad_cuda, volume)


def voxel_grad_block_stats(volume: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                           hit: torch.Tensor, tf_scalars: torch.Tensor, gc: torch.Tensor,
                           gaT_term: torch.Tensor, P_tot: torch.Tensor,
                           max_samples: int = MAX_SAMPLES):
    """One launch of :func:`voxel_grad_cuda`'s kernel (CUDA tensors only; the
    volume uint8 or float32, as there) with its per-block counters.  Returns
    (g_vol, dict): the blocks that accumulated in their shared tile
    (``tiled``), those that added to device
    memory directly (``global``, their box beyond the kernel's tile of
    ``tile_budget_floats``) and those without an alive step (``empty``); the
    global atomicAdds of the launch, and the 8 per alive step a launch
    without the tile would make (``global_atomics_untiled``); and the median
    and largest box (voxels) of the nonempty blocks.  Adds one to
    ``voxel_grad_cuda.launches`` (and its ``f32_launches`` for a float32
    volume)."""
    tensors = _checked_inputs(volume, entry_uv, dir_step, hit, tf_scalars, gc, gaT_term, P_tot,
                              max_samples, "clamp")
    if volume.device.type != "cuda":
        raise ValueError("voxel_grad_block_stats counts the kernel's blocks: CUDA tensors only")
    lib = load_kernel().lib
    H, W = hit.shape
    bx, by = lib.voxel_grad_block_x(), lib.voxel_grad_block_y()
    budget = lib.voxel_grad_tile_budget()
    stats = torch.zeros((-(-H // by) * -(-W // bx), 3), dtype=torch.int32, device=volume.device)
    g_vol = torch.zeros(volume.shape, dtype=torch.float32, device=volume.device)
    _launch_vg(tensors, max_samples, g_vol, stats)
    box = stats[:, 0].long()
    nonempty = box[box > 0]
    n_tiled = int(((box > 0) & (box <= budget)).sum())
    return g_vol, {
        "block": [by, bx], "tile_budget_floats": budget, "blocks": int(box.numel()),
        "tiled": n_tiled, "global": int(nonempty.numel()) - n_tiled,
        "empty": int(box.numel() - nonempty.numel()),
        "global_atomics": int(stats[:, 1].long().sum()),
        "global_atomics_untiled": 8 * int(stats[:, 2].long().sum()),
        "box_voxels_median": float(nonempty.float().median()) if nonempty.numel() else 0.0,
        "box_voxels_max": int(nonempty.max()) if nonempty.numel() else 0}


def _voxel_grad(params: TFParams, volume: torch.Tensor, plan: CompositingPlan,
                gc: torch.Tensor, gaT_term: torch.Tensor, P_tot: torch.Tensor):
    """The backward's voxel gradient (``vr.voxel_grad``).  On the card B5
    reads the float32 or uint8 volume in place (a view is copied), a float32
    one quantized tap by tap; on the CPU the plain version samples the 8-bit
    grid, made here by ``quantize_u8`` (``vr.voxel_grad.quantize``), the one
    byte copy left."""
    with span("vr.voxel_grad"):
        if volume.device.type == "cpu":
            with span("vr.voxel_grad.quantize"):
                volume = quantize_u8(volume)
        volume = volume.contiguous()
        return voxel_grad_cuda(volume, plan.entry_uv, plan.dir_step, plan.hit,
                               _tf_scalars(params), gc.contiguous(), gaT_term.contiguous(),
                               P_tot.contiguous(), plan.max_samples, plan.wrap)


def voxel_grad_kernel(params: TFParams, volume: torch.Tensor, plan: CompositingPlan,
                      g_rgb, g_alpha, alpha_T: torch.Tensor, P_tot: torch.Tensor):
    """The voxel cotangent of one rendered frame, given the output cotangents
    (``None`` counts as zero) and the forward pass's (alpha_T, P_total)
    images.  ``volume`` is (Z, Y, X) float32 or uint8 on the plan's device;
    the gradient is the byte route's on ``quantize_u8(volume)``, and any
    other dtype raises ValueError."""
    check_plan(plan)
    gc, gaT_term = cotangent_images(params, g_rgb, g_alpha, alpha_T)
    return _voxel_grad(params, volume, plan, gc, gaT_term, P_tot)


def make_render_tf_voxel(plan: CompositingPlan):
    """A differentiable ``f(params, volume) -> (rgb, alpha)`` with both
    TF-parameter and voxel gradients at kernel speed: the forward is the
    TF march kernel; the backward takes its closed-form parameter gradients
    and one voxel-gradient kernel pass.  Both kernels read a float32 volume
    in place and quantize each tap as they read it, so on the card neither
    pass makes a byte copy of the volume.  Raises ValueError for a plan
    whose wrap is not clamp."""
    return bind_render_tf(plan, _voxel_grad)
