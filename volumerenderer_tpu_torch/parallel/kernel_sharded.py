"""Sharded launches of the CUDA kernels: image rows over a mesh (B1, B4, B5),
and the volume-sharded layouts through the segment marches (B10, B11).

Counterpart of ``volumerenderer_tpu/parallel/kernel_sharded.py``.  Where JAX
runs one ``shard_map`` body per device, each process of the port runs its own
shards (``DeviceMesh.local_indices``; every shard in one process) one after
another, each launching on its device; the results gather in mesh order
(``multihost.gather``: copies to the mesh's first device in one process, an
``all_gather`` to every process over several) and are reduced there in that
order, so a run over several processes equals the one-process run bit for
bit (but B5's float atomics).

* Row-sharded (``render_planned_sharded``, ``tf_fit_step_kernel``,
  ``voxel_fit_step_kernel``): each device marches its block of image rows
  (``CompositingPlan.rows``) with the kernel the single-device path uses, on
  its byte route: the volume is quantized once (a uint8 volume is its own
  bytes) and each device receives the
  byte volume, a quarter of the float32 bytes (the voxel step's B5 reads
  bytes anyway); the images gather, and the loss and the gradients sum in
  mesh order.  Rays never interact, and the byte route samples what
  the float32 route does, so a row-sharded frame equals the plan's, bit for
  bit.
* Volume-sharded (``render_zsharded_kernel``, ``render_bricksharded_kernel``,
  ``tf_fit_step_bricksharded``): the volume is split in z, or in (z, y)
  bricks with x whole (``nbx == 1``), as ``parallel/context.py`` and
  ``parallel/bricks.py`` split it.  Every call quantizes each shard to 8 bits
  on its device, exchanges one halo plane in z and one row in y
  (``bricks.extend_halos``), launches the segment march once per shard
  (``ops/cuda/seg_kernel.py``), and composes the shards' segment maps in
  per-ray traversal order after the gather.  Each march starts from its
  shard's entry table, which depends on the rays and the owned box only: it
  is built at a plan's first sharded call and kept in
  ``CompositingPlan.seg_starts`` of the process that marches the shard.  No
  early-out: equal to the unsharded march without it, so within the
  early-out envelope of the dense frame (``docs/PARITY.md`` deviation 6).

Not ported: the ``_LRU`` caches of jitted ``shard_map`` bodies (torch has no
trace to cache), the ``words`` arguments (the entry tables take the word
tables' place), and the TPU window checks of ``seg_plan_ok``.  The halo is one plane
per axis, so JAX's ``_extend_axis_h`` is ``bricks.extend_halos`` here.
``scaling_probe_kernel`` drops the ``words`` argument for the same reason.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..diff.closed_form import cotangent_images, tf_param_grads, tf_scalars
from ..diff.transfer import TFParams
from ..ops.cuda.raycast_kernel import CompositingPlan, composite_march_cuda, quantize_u8
from ..ops.cuda.seg_kernel import (compose_tf_segments, seg_entry_table_cuda, seg_march_cuda,
                                   seg_tf_march_cuda)
from ..ops.cuda.tf_kernel import check_plan, tf_march_cuda
from ..ops.cuda.voxel_grad_kernel import voxel_grad_cuda
from ..ops.raycast import apply_reference_transfer
from ..ops.sampling import as_normalized_volume
from . import multihost
from .bricks import as_sharded, composite_segments_ordered, extend_halos
from .sharding import DeviceMesh

__all__ = ["plan_shardable", "render_planned_sharded", "tf_fit_step_kernel",
           "voxel_fit_step_kernel", "seg_plan_ok", "seg_shards", "shard_starts",
           "render_zsharded_kernel", "render_bricksharded_kernel", "tf_fit_step_bricksharded",
           "scaling_probe_kernel"]


def plan_shardable(plan: CompositingPlan, n: int) -> bool:
    """A plan shards over ``n`` devices when its image rows split into ``n``
    equal blocks."""
    return plan.shape[0] % n == 0


def _row_shards(mesh: DeviceMesh, plan: CompositingPlan, axis: str):
    """The flat indices of the entries along ``axis``, and (device, rows
    slice, the plan of those rows on that device) for each of them that
    this process owns."""
    entries = mesh.axis_indices(axis)
    if not plan_shardable(plan, len(entries)):
        raise ValueError(f"{plan.shape[0]} image rows do not split over {len(entries)} devices")
    n = plan.shape[0] // len(entries)
    shards = []
    for j, i in enumerate(entries):
        if mesh.is_local(i):
            dev = mesh.devices.flat[i]
            shards.append((dev, slice(j * n, (j + 1) * n), plan.rows(j * n, (j + 1) * n, dev)))
    return entries, shards


def render_planned_sharded(mesh: DeviceMesh, plan: CompositingPlan, volume: torch.Tensor,
                           axis: str = "rays"):
    """Render a planned view with image rows sharded over ``mesh`` axis
    ``axis``: a float32 volume in [0, 1] is quantized to bytes once (a
    uint8 volume is its own bytes) and the byte volume, a quarter of the
    float32 bytes, is copied to each of this process's devices, which runs
    the march (B1, the transfer in its epilogue) on its rows.  Returns
    (rgb, alpha) as full (H, W) images on ``mesh.home`` (the mesh's first
    device in one process), equal bit for bit to ``plan.render(volume)``,
    whose taps are quantized as they are read."""
    plan.check_volume(volume)
    vol_u8 = quantize_u8(volume)
    entries, shards = _row_shards(mesh, plan, axis)
    local = [composite_march_cuda(vol_u8.to(dev), sub.entry_uv, sub.dir_step, sub.hit,
                                  sub.max_samples, sub.wrap)
             for dev, _, sub in shards]
    parts = multihost.gather(mesh, local, entries)
    return torch.cat([rgb for rgb, _ in parts]), torch.cat([a for _, a in parts])


def _mse_grads(params: TFParams, partials, target: torch.Tensor, npix: int):
    """The MSE loss's summed squared error over ``target``'s pixels and the
    TF gradients of ``sum(resid^2) / npix`` from the seven partial images
    (``diff/closed_form.py``), with ``gc`` for the voxel pass."""
    rgb = params.flip_sign * partials[0][..., None] + params.flip_bias
    resid = rgb - target
    g_rgb = 2.0 * resid / npix
    gc, gaT_term = cotangent_images(params, g_rgb, None, partials[1])
    return torch.sum(resid * resid), tf_param_grads(params, partials, g_rgb, gc, gaT_term), gc


def _on(params: TFParams, device) -> TFParams:
    return TFParams(*(t.to(device) for t in params))


def _row_sharded_step(mesh, plan, params, volume, target_rgb, axis, voxel: bool):
    # quantized once, here: the byte volume each device receives is a
    # quarter of the float32 bytes; B4 and B5 read the bytes directly
    check_plan(plan)
    plan.check_volume(volume)
    vol_u8 = quantize_u8(volume)
    npix = target_rgb.numel()
    entries, shards = _row_shards(mesh, plan, axis)
    local = []
    for dev, rows, sub in shards:
        p = _on(params, dev)
        u8 = vol_u8.to(dev)
        tf = tf_scalars(p)
        partials = tf_march_cuda(u8, sub.entry_uv, sub.dir_step, sub.hit, tf, sub.max_samples,
                                 sub.wrap)
        sq, g, gc = _mse_grads(p, partials, target_rgb[rows].to(dev), npix)
        if voxel:
            g = (*g, voxel_grad_cuda(u8, sub.entry_uv, sub.dir_step, sub.hit, tf,
                                     gc.contiguous(), torch.zeros_like(gc),
                                     partials[3].contiguous(), sub.max_samples, sub.wrap))
        local.append((sq, *g))
    # the sums run in mesh order from zero, in one process as over several
    home = mesh.home
    loss = torch.zeros((), dtype=torch.float32, device=home)
    grads = [torch.zeros(p.shape, dtype=p.dtype, device=home) for p in params]
    if voxel:
        grads.append(torch.zeros(volume.shape, dtype=torch.float32, device=home))
    for sq, *g in multihost.gather(mesh, local, entries):
        loss = loss + sq
        grads = [a + b for a, b in zip(grads, g)]
    g_vol = grads.pop() if voxel else None
    return loss / npix, TFParams(*grads), g_vol


def tf_fit_step_kernel(mesh: DeviceMesh, plan: CompositingPlan, params: TFParams,
                       volume: torch.Tensor, target_rgb: torch.Tensor, lr: float = 1e-2,
                       axis: str = "rays"):
    """One SGD step of the TF fit (MSE against ``target_rgb`` (H, W, 3)) with
    image rows sharded over ``axis``: each device runs one TF march (B4) on
    its rows and forms its closed-form parameter gradients; the losses and
    gradients gather and sum in mesh order.  Returns (new_params, loss) on
    ``mesh.home`` (the mesh's first device in one process)."""
    loss, grads, _ = _row_sharded_step(mesh, plan, params, volume, target_rgb, axis, False)
    params = _on(params, mesh.home)
    return TFParams(*(p - lr * g for p, g in zip(params, grads))), loss


def voxel_fit_step_kernel(mesh: DeviceMesh, plan: CompositingPlan, params: TFParams,
                          volume: torch.Tensor, target_rgb: torch.Tensor,
                          lr_vol: float = 1e-1, lr_tf: float = 1e-2, axis: str = "rays"):
    """One SGD step of the voxels and the TF parameters with image rows
    sharded over ``axis``: each device runs the TF march (B4) and one
    voxel-gradient pass (B5) on its rows; the (Z, Y, X) cotangent volumes
    gather and sum in mesh order beside the parameter gradients.  ``volume``
    is float32 in [0, 1] or uint8 (bytes / 255).  Returns (new_params,
    new_volume float32 clamped to [0, 1], loss) on ``mesh.home``."""
    loss, grads, g_vol = _row_sharded_step(mesh, plan, params, volume, target_rgb, axis, True)
    params = _on(params, mesh.home)
    new_params = TFParams(*(p - lr_tf * g for p, g in zip(params, grads)))
    new_volume = torch.clamp(as_normalized_volume(volume, mesh.home) - lr_vol * g_vol, 0.0, 1.0)
    return new_params, new_volume, loss


def seg_plan_ok(plan: CompositingPlan, n_z: int, n_y: int = 1, n_x: int = 1) -> bool:
    """A plan runs the segment marches on an (n_z, n_y, n_x) shard grid when
    the volume's Z and Y split evenly, x stays whole (``n_x == 1``) and the
    plan clamps (the segment marches are clamp-only)."""
    X, Y, Z = plan.dims
    return plan.wrap == "clamp" and n_x == 1 and Z % n_z == 0 and Y % n_y == 0


def seg_shards(mesh: DeviceMesh, plan: CompositingPlan, volume):
    """The inputs of the segment marches, one of this process's shards at a
    time: each shard quantized to 8 bits on its device (a uint8 volume's
    shards are its own bytes), then one halo plane in z and one row in y
    exchanged (across processes where the next shard lies on another).
    Returns [(slab_u8, launch keywords: dims, z_lo, n_z, y_lo, n_y,
    max_samples)] for ``mesh.local_indices()``, in the mesh's order."""
    sv = as_sharded(mesh, volume)
    nz, ny, nx = sv.bricks.shape
    if tuple(sv.shape) != plan.dims[::-1]:
        raise ValueError(f"volume {tuple(sv.shape)} does not match the plan's (Z, Y, X) = "
                         f"{plan.dims[::-1]}")
    if not seg_plan_ok(plan, nz, ny, nx):
        raise ValueError(f"the segment marches take a clamp plan and a (z, y) split with x "
                         f"whole, got {(nz, ny, nx)} shards and wrap={plan.wrap!r}")
    Sz, Sy, _ = sv.brick_shape
    u8 = np.empty(sv.bricks.shape, dtype=object)
    local = [np.unravel_index(i, u8.shape) for i in mesh.local_indices()]
    for idx in local:
        u8[idx] = quantize_u8(sv.bricks[idx])
    slabs = extend_halos(u8, axes=(0, 1) if ny > 1 else (0,), mesh=mesh)
    return [(slabs[iz, iy, 0], dict(dims=plan.dims, z_lo=int(iz) * Sz, n_z=Sz,
                                    y_lo=int(iy) * Sy, n_y=Sy, max_samples=plan.max_samples))
            for iz, iy, _ in local]


def shard_starts(plan: CompositingPlan, kw: dict, device):
    """The entry table of ``plan``'s rays on one shard (``kw``: the launch
    keywords of :func:`seg_shards`) on ``device``: built at first use
    (``seg_entry_table_cuda``) and kept in ``plan.seg_starts`` by (owned
    box, max_samples, device), so every later frame and fit step of the
    camera reuses it.  Each table holds 16 bytes per ray (16.8 MB at 1024²)
    until the plan goes or ``plan.seg_starts.clear()``."""
    box = (kw["z_lo"], kw["z_lo"] + kw["n_z"], kw["y_lo"], kw["y_lo"] + kw["n_y"])
    key = (box, kw["max_samples"], torch.device(device))
    starts = plan.seg_starts.get(key)
    if starts is None:
        rays = (plan.entry_uv.to(device), plan.dir_step.to(device), plan.hit.to(device))
        starts = plan.seg_starts[key] = seg_entry_table_cuda(*rays, **kw)
    return starts


def _seg_launches(mesh: DeviceMesh, plan: CompositingPlan, volume, tf: torch.Tensor | None):
    """The segment march once per shard (B10, or B11 with the TF scalars
    ``tf``) on :func:`seg_shards`' inputs, each from its entry table
    (:func:`shard_starts`).  Returns the outputs of every shard, gathered
    in mesh order and stacked per field, (n_shards, H, W) each, on
    ``mesh.home`` (the mesh's first device in one process)."""
    outs = []
    for slab, kw in seg_shards(mesh, plan, volume):
        dev = slab.device
        rays = (plan.entry_uv.to(dev), plan.dir_step.to(dev), plan.hit.to(dev))
        starts = shard_starts(plan, kw, dev)
        if tf is None:
            out = seg_march_cuda(slab, *rays, **kw, starts=starts)
        else:
            out = seg_tf_march_cuda(slab, *rays, tf.to(dev), **kw, starts=starts)
        outs.append(out)
    return [torch.stack(field) for field in zip(*multihost.gather(mesh, outs))]


def _seg_composite(C_all, A_all, tf_all):
    """Per-shard segment maps -> (rgb, alpha) by the traversal-ordered fold."""
    color, alpha = composite_segments_ordered(C_all, 1.0 - A_all, tf_all)
    return apply_reference_transfer(color, alpha), alpha


def render_zsharded_kernel(mesh: DeviceMesh, plan: CompositingPlan, volume, axis: str = "z"):
    """Context-parallel render, the volume z-sharded over the 1-D ``mesh``
    (``parallel/context.py``'s layout), with the segment march (B10) in each
    shard.  ``volume`` is a (Z, Y, X) float32 tensor or a ``ShardedVolume``
    of this mesh (``bricks.shard_volume``).  Returns (rgb, alpha) on
    ``mesh.home``, on every process of the mesh: the same ownership split
    and segment maps as ``render_zsharded``, with positions by repeated
    addition."""
    if mesh.devices.ndim != 1 or mesh.axis_names != (axis,):
        raise ValueError(f"expected a 1-D mesh with axis {axis!r}, got {mesh.axis_names}")
    return _seg_composite(*_seg_launches(mesh, plan, volume, None))


def render_bricksharded_kernel(mesh: DeviceMesh, plan: CompositingPlan, volume):
    """Brick-sharded render (``parallel/bricks.py``'s layout, mesh axes
    ("bz", "by", "bx") with ``bx == 1``) with the segment march (B10) in each
    brick.  x stays whole: one thread marches one ray through all of its
    row.  Returns (rgb, alpha) on ``mesh.home``, on every process of the
    mesh."""
    return _seg_composite(*_seg_launches(mesh, plan, volume, None))


def tf_fit_step_bricksharded(mesh: DeviceMesh, plan: CompositingPlan, params: TFParams,
                             volume, target_rgb: torch.Tensor, lr: float = 1e-2):
    """One TF-fit SGD step (MSE against ``target_rgb`` (H, W, 3)) with the
    volume brick-sharded (mesh axes ("bz", "by", "bx"), ``bx == 1``): each
    brick runs the segment march with the TF sums (B11), the sums compose
    in per-ray traversal order (``compose_tf_segments``) into the global
    partials of the unsharded TF march without early-out, and the
    gradients follow the single-device formulas.  Returns (new_params,
    loss) on ``mesh.home``, on every process of the mesh."""
    check_plan(plan)
    params = _on(params, mesh.home)
    C, A, t_first, R, P, QP, SG, SB = _seg_launches(mesh, plan, volume, tf_scalars(params))
    partials = compose_tf_segments(C, A, t_first, R, P, QP, SG, SB)
    target = target_rgb.to(mesh.home)
    sq, grads, _ = _mse_grads(params, partials, target, target.numel())
    return TFParams(*(p - lr * g for p, g in zip(params, grads))), sq / target.numel()



def scaling_probe_kernel(mesh: DeviceMesh, plan: CompositingPlan, volume, frames: int = 4,
                         axis: str = "rays") -> float:
    """Per-device throughput ratio of the row-sharded kernel render
    (:func:`render_planned_sharded`, B1) on the full mesh against a mesh of
    this process's first device alone: ``(t_one / n) / t_mesh``.  Each
    timing enqueues ``frames`` renders back to back and forces them once,
    by one scalar read to the host, after a warm render."""

    def bench(m):
        def frame():
            rgb, a = render_planned_sharded(m, plan, volume, axis=axis)
            return torch.sum(rgb) + torch.sum(a)

        frame().item()
        t0 = time.perf_counter()
        s = torch.zeros((), device=m.home)
        for _ in range(frames):
            s = s + frame()
        if not np.isfinite(s.item()):  # the one forced read
            raise FloatingPointError(f"the probe's renders sum to {s.item()}")
        return (time.perf_counter() - t0) / frames

    t_mesh = bench(mesh)
    t_one = bench(DeviceMesh([mesh.home], (axis,)))
    return (t_one / mesh.size) / t_mesh
