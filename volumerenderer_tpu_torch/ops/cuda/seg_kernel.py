"""Segment marches on one volume shard: the launch wrappers of
``csrc/seg_march.cu`` (the entry table, B10 and B11) and the composition of
the shards' TF sums.

Counterpart of ``volumerenderer_tpu/ops/pallas/seg_kernel.py``
(``launch_seg``, ``launch_seg_tf``, ``build_word_table_seg``,
``compose_tf_segments``, ``BIG_T``).  A shard of a volume-sharded layout (a
z-slab or a (z, y) brick) holds its owned rows and one halo plane and row
(``ops/sampling.py::sample_trilinear_shard``); the kernel marches every ray
against it, composites only the samples whose anchor the shard owns, and
returns each ray's affine segment map.  The maps of the shards compose in
per-ray traversal order (``parallel/bricks.py::composite_segments_ordered``,
and :func:`compose_tf_segments` for the TF sums).

In place of ``build_word_table_seg``'s group skip, each march starts from a
:class:`SegStarts` table (:func:`seg_entry_table_cuda`): each ray's first
owned step and its position there.  The table depends on the rays and the
owned box only, so a plan keeps it (``parallel/kernel_sharded.py::
shard_starts``).

Each wrapper dispatches on where its tensors lie: CUDA tensors launch the
kernel, CPU tensors run the plain PyTorch version
(``ops/raycast.py::seg_entry_table``, ``seg_march_steps``,
``diff/closed_form.py::seg_tf_march_steps``, with ``ops/sampling.py::
shard_sampler``).  There is no fallback from one to the other: a CUDA input
the kernel cannot take raises.  Clamp-only, as the TPU kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ...diff.closed_form import seg_tf_march_steps
from ..raycast import BIG_T, MAX_SAMPLES, seg_entry_table, seg_march_steps
from ..sampling import as_normalized_volume, shard_sampler
from . import _build
from ._launch import (INT32_MAX, bind, check_box, check_hit, check_image, check_max_samples,
                      check_shard, check_tensors, launch)

__all__ = ["seg_march_cuda", "seg_tf_march_cuda", "seg_entry_table_cuda", "SegStarts",
           "compose_tf_segments", "load_kernel", "BIG_T"]


@functools.cache
def _entry_launcher():
    # entry_uv, dir_step, hit; H, W, Y, Z, z_lo, z_hi, y_lo, y_hi,
    # max_samples; starts, stream
    return bind("seg_march", 3, 9, [ctypes.c_void_p] * 2, entry="seg_entry")


@functools.cache
def _launcher():
    # starts, dir_step, slab; H, W, X, Y, Z, z_lo, z_hi, y_lo, y_hi, Ez, Ey,
    # max_samples; out, stream
    return bind("seg_march", 3, 12, [ctypes.c_void_p] * 2)


@functools.cache
def _tf_launcher():
    # starts, dir_step, slab, tf; the same ints; out, stream
    return bind("seg_march", 4, 12, [ctypes.c_void_p] * 2, entry="seg_tf_march")


def load_kernel() -> _build.BuiltLibrary:
    """Build (at first use) and load the segment marches' library (the
    entry table, B10, B11)."""
    return _launcher()[1]


@dataclasses.dataclass(frozen=True, eq=False)
class SegStarts:
    """The entry table of one ray image on one shard
    (``ops/raycast.py::seg_entry_table``): ``entry`` (H, W, 4) float32, the
    position after each ray's first owned step index ``i0`` additions and
    the int32 bits of ``i0`` (-1: none).  ``dims``, ``box`` and
    ``max_samples`` are what it was built for."""

    entry: torch.Tensor
    dims: tuple
    box: tuple
    max_samples: int


def _check_rays(tensors: dict, ref: str, max_samples) -> None:
    check_tensors(tensors, ref)
    hit = tensors["hit"]
    check_hit(hit)
    check_image(tensors, hit.shape, torch.float32, ("entry_uv", "dir_step"), (3,))
    check_max_samples(max_samples)


def seg_entry_table_cuda(entry_uv: torch.Tensor, dir_step: torch.Tensor, hit: torch.Tensor,
                         dims, z_lo: int, n_z: int, y_lo: int, n_y: int,
                         max_samples: int = MAX_SAMPLES) -> SegStarts:
    """The entry table of (H, W) rays on the shard that owns the anchors
    [z_lo, z_lo + n_z) x [y_lo, y_lo + n_y) of a volume of ``dims`` = (X,
    Y, Z) (arguments as :func:`seg_march_cuda`'s).  CUDA tensors run the
    table kernel and add one to ``seg_entry_table_cuda.launches``; CPU
    tensors run ``ops/raycast.py::seg_entry_table``."""
    _check_rays({"entry_uv": entry_uv, "dir_step": dir_step, "hit": hit}, "entry_uv",
                max_samples)
    box = check_box(dims, z_lo, n_z, y_lo, n_y)
    _, Y, Z = dims = tuple(int(d) for d in dims)
    if entry_uv.device.type == "cpu":
        entry = seg_entry_table(entry_uv, dir_step, hit.to(torch.bool), dims, box, max_samples)
        return SegStarts(entry, dims, box, max_samples)
    H, W = hit.shape
    entry = torch.empty((H, W, 4), dtype=torch.float32, device=entry_uv.device)
    if H * W > 0:
        launch(_entry_launcher, "seg_march", entry_uv.device, entry_uv.data_ptr(),
               dir_step.data_ptr(), hit.data_ptr(), H, W, Y, Z, *box, max_samples,
               entry.data_ptr())
        seg_entry_table_cuda.launches += 1
    return SegStarts(entry, dims, box, max_samples)


seg_entry_table_cuda.launches = 0


def _check_starts(starts: SegStarts, dims, box, max_samples, hit, device):
    if not isinstance(starts, SegStarts):
        raise TypeError(f"starts must be a SegStarts, got {type(starts).__name__}")
    if (starts.dims, starts.box, starts.max_samples) != (dims, box, max_samples):
        raise ValueError(f"starts were built for dims {starts.dims}, box {starts.box}, "
                         f"max_samples {starts.max_samples}; this march has {dims}, {box}, "
                         f"{max_samples}")
    tensors = {"starts.entry": starts.entry}
    check_tensors(tensors, "starts.entry")
    check_image(tensors, hit.shape, torch.float32, ("starts.entry",), (4,))
    if starts.entry.device != device:
        raise ValueError(f"starts lie on {starts.entry.device}, the slab on {device}")
    if starts.entry.data_ptr() % 16:
        raise ValueError("starts.entry must be 16-byte aligned")


def _segment(wrapper, slab_u8, entry_uv, dir_step, hit, tf_scalars, dims, z_lo, n_z, y_lo,
             n_y, max_samples, starts):
    tensors = {"slab_u8": slab_u8, "entry_uv": entry_uv, "dir_step": dir_step, "hit": hit}
    if tf_scalars is not None:
        tensors["tf_scalars"] = tf_scalars
    _check_rays(tensors, "slab_u8", max_samples)
    box = check_shard(slab_u8, dims, z_lo, n_z, y_lo, n_y)
    if tf_scalars is not None:
        check_image(tensors, (), torch.float32, ("tf_scalars",), (3,))
    dims = tuple(int(d) for d in dims)
    if starts is not None:
        _check_starts(starts, dims, box, max_samples, hit, slab_u8.device)
    if slab_u8.device.type == "cpu":
        sample = shard_sampler(as_normalized_volume(slab_u8), dims, box[0], box[2])
        entry = None if starts is None else starts.entry
        if tf_scalars is None:
            return seg_march_steps(sample, entry_uv, dir_step, hit.to(torch.bool), dims, box,
                                   max_samples, entry)
        return seg_tf_march_steps(sample, entry_uv, dir_step, hit.to(torch.bool), tf_scalars,
                                  dims, box, max_samples, entry)
    if slab_u8.numel() > INT32_MAX:
        raise ValueError(f"slab {tuple(slab_u8.shape)} exceeds 2^31 bytes (32-bit offsets)")
    H, W = hit.shape
    X, Y, Z = dims
    Ez, Ey, _ = slab_u8.shape
    n_planes = 3 if tf_scalars is None else 8
    out = torch.empty((n_planes, H, W), dtype=torch.float32, device=slab_u8.device)
    if H * W > 0:
        if starts is None:
            starts = seg_entry_table_cuda(entry_uv, dir_step, hit, dims, z_lo, n_z, y_lo, n_y,
                                          max_samples)
        pointers = [starts.entry.data_ptr(), dir_step.data_ptr(), slab_u8.data_ptr()]
        if tf_scalars is not None:
            pointers.append(tf_scalars.data_ptr())
        launch(_launcher if tf_scalars is None else _tf_launcher, "seg_march", slab_u8.device,
               *pointers, H, W, X, Y, Z, *box, Ez, Ey, max_samples, out.data_ptr())
        wrapper.launches += 1
    return tuple(out.unbind(0))


def seg_march_cuda(slab_u8: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                   hit: torch.Tensor, dims, z_lo: int, n_z: int, y_lo: int, n_y: int,
                   max_samples: int = MAX_SAMPLES, starts: SegStarts | None = None):
    """B10: the compositing march on one shard, as a segment map.

    Args:
      slab_u8: (Ez, Ey, X) uint8, the shard's owned rows and halo of the
        global volume (``_launch.check_shard``), x fastest.
      entry_uv, dir_step: (H, W, 3) float32 (positions advance by repeated
        ``pos + dir_step``).
      hit: (H, W) uint8, nonzero where the ray enters the cube.
      dims: (X, Y, Z) of the global volume.
      z_lo, n_z, y_lo, n_y: the owned anchor box [z_lo, z_lo + n_z) x
        [y_lo, y_lo + n_y) (a z-slab owns all rows: y_lo = 0, n_y = Y).
      starts: these rays' entry table on this box
        (:func:`seg_entry_table_cuda`); a CUDA call without one builds it
        first.

    Returns (C_seg, alpha_seg, t_first), each (H, W) float32
    (``ops/raycast.py::seg_march_steps``).  CUDA tensors run the kernel and
    add one to ``seg_march_cuda.launches``; CPU tensors run the plain
    version (from ``starts`` where given).
    """
    return _segment(seg_march_cuda, slab_u8, entry_uv, dir_step, hit, None, dims, z_lo, n_z,
                    y_lo, n_y, max_samples, starts)


seg_march_cuda.launches = 0


def seg_tf_march_cuda(slab_u8: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                      hit: torch.Tensor, tf_scalars: torch.Tensor, dims, z_lo: int, n_z: int,
                      y_lo: int, n_y: int, max_samples: int = MAX_SAMPLES,
                      starts: SegStarts | None = None):
    """B11: :func:`seg_march_cuda` with the TF parameters and the five TF
    gradient sums, with the shard's local alpha.  ``tf_scalars`` is (3,)
    float32 (K, G, B) on the slab's device.

    Returns the eight (H, W) float32 images (C_seg, alpha_seg, t_first, R, P,
    QP, SG, SB) (``diff/closed_form.py::seg_tf_march_steps``).  CUDA tensors
    run the kernel and add one to ``seg_tf_march_cuda.launches``; CPU
    tensors run the plain version.
    """
    return _segment(seg_tf_march_cuda, slab_u8, entry_uv, dir_step, hit, tf_scalars, dims,
                    z_lo, n_z, y_lo, n_y, max_samples, starts)


seg_tf_march_cuda.launches = 0


def compose_tf_segments(C_all, A_all, tf_all, R_all, P_all, QP_all, SG_all, SB_all):
    """Fold (N, H, W) per-shard TF segments in per-ray traversal order
    (ascending ``t_first``; a shard that owns no sample of a ray is an
    identity map).  With ``tau_up`` the product of the upstream shards'
    transmittances and ``P_up`` the upstream color prefix:

        C  += tau_up * C_seg;        R  += R_seg
        QP += R_seg * P_up + tau_up * QP_seg
        SG += tau_up * SG_seg;       SB += tau_up * SB_seg
        P_up += tau_up * P_seg;      tau_up *= 1 - alpha_seg

    Returns the global (color_T, alpha_T, R, P_total, QP, SG, SB): the
    partials ``tf_march_cuda`` gives on the unsharded volume without
    early-out.  The same fold as the JAX function, in its order."""
    order = torch.argsort(tf_all, dim=0, stable=True)

    def take(a):
        return torch.gather(a, 0, order)

    Cs, As, Rs = take(C_all), take(A_all), take(R_all)
    Ps, QPs, SGs, SBs = take(P_all), take(QP_all), take(SG_all), take(SB_all)
    z = torch.zeros_like(C_all[0])
    c, tau, P_up, R, QP, SG, SB = z, torch.ones_like(z), z, z, z, z, z
    for i in range(C_all.shape[0]):
        c = c + tau * Cs[i]
        QP = QP + Rs[i] * P_up + tau * QPs[i]
        R = R + Rs[i]
        SG = SG + tau * SGs[i]
        SB = SB + tau * SBs[i]
        P_up = P_up + tau * Ps[i]
        tau = tau * (1.0 - As[i])
    return c, 1.0 - tau, R, P_up, QP, SG, SB
