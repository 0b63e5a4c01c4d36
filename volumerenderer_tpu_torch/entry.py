"""A dry run of every sharded layout at small shapes.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (its ``entry()``
counterpart belongs to the port's bench).  JAX's interpret-mode patch has no
counterpart: on CPU devices each kernel wrapper runs its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from .camera import Camera, generate_rays
from .diff.transfer import TFParams
from .io.synthetic import sphere_volume
from .models import plan_compositing
from .ops.sampling import as_normalized_volume
from .parallel.bricks import make_brick_mesh, render_bricksharded, shard_volume
from .parallel.context import make_z_mesh, render_zsharded
from .parallel.kernel_sharded import (plan_shardable, render_planned_sharded,
                                      render_zsharded_kernel, seg_plan_ok,
                                      tf_fit_step_bricksharded, tf_fit_step_kernel)
from .parallel.sharding import DeviceMesh, default_devices, make_mesh, tf_fit_step

__all__ = ["dryrun_multichip"]


def _finite(name: str, t: torch.Tensor) -> None:
    if not bool(torch.isfinite(t).all()):
        raise FloatingPointError(f"dryrun_multichip: {name} is not finite")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run each sharded layout once over ``n_devices`` devices (default: the
    host's cards, round-robin; on the CPU pass ``[torch.device("cpu")] *
    n``), checking that every result is finite and that the brick-sharded
    render equals the z-sharded one (atol 1e-5): the ``(dp, rays)`` TF fit
    step, ``render_zsharded``, ``render_bricksharded``, and on the kernels
    ``render_planned_sharded``, ``tf_fit_step_kernel``,
    ``render_zsharded_kernel`` and ``tf_fit_step_bricksharded``."""
    devices = default_devices(n_devices) if devices is None else list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
    dev = devices[0]

    # dp shards the view batch, rays shards image rows within a view
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, dp=dp, devices=devices)
    rays_axis = n_devices // dp
    vol = as_normalized_volume(sphere_volume((16, 16, 16)), device=dev)
    H, W, B = 4 * rays_axis, 8, dp
    rays = generate_rays(Camera(width=W, height=H), device=dev)

    def batch(x):
        return x.expand((B,) + tuple(x.shape))

    target = torch.zeros((B, H, W, 3), dtype=torch.float32, device=dev)
    params = TFParams.reference(dev)
    _, loss = tf_fit_step(mesh, params, vol, batch(rays.entry_uv), batch(rays.direction),
                          batch(rays.hit), target, max_samples=32)
    _finite("the (dp, rays) fit step's loss", loss)

    # context-parallel: the volume z-sharded, halos exchanged, segments folded
    zmesh = make_z_mesh(n_devices, devices=devices)
    rgb, _ = render_zsharded(zmesh, vol, rays.entry_uv, rays.direction, rays.hit, max_samples=16)
    _finite("render_zsharded", rgb)

    # brick-sharded (BASELINE config 5's layout), held to the z-sharded render
    if n_devices % 2 == 0:
        bshape = (2, 2, n_devices // 4) if n_devices % 4 == 0 else (2, n_devices // 2, 1)
    else:
        bshape = (n_devices, 1, 1)
    bmesh = make_brick_mesh(bshape, devices=devices)
    rgb_b, _ = render_bricksharded(bmesh, shard_volume(bmesh, vol), rays.entry_uv,
                                   rays.direction, rays.hit, max_samples=16)
    err = float((rgb_b - rgb).abs().max())
    if err > 1e-5:
        raise AssertionError(f"dryrun_multichip: brick-sharded render off the z-sharded one by "
                             f"{err} (atol 1e-5)")

    # the kernel-sharded paths: rows over a 1-D mesh (B1, B4), the segment
    # march in z shards (B10) and in bricks with the TF sums (B11)
    kvol = as_normalized_volume(sphere_volume((64, 32, 128)), device=dev)
    Zk, Yk, Xk = kvol.shape
    krays = generate_rays(Camera(width=64, height=64), device=dev)
    ktarget = torch.zeros(tuple(krays.entry_uv.shape[:-1]) + (3,), dtype=torch.float32,
                          device=dev)
    kplan = plan_compositing(krays.entry_uv, krays.direction, krays.hit, (Xk, Yk, Zk),
                             max_samples=24)
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices
    rmesh = DeviceMesh(grid, ("rays",))
    if plan_shardable(kplan, n_devices):
        rgb_s, _ = render_planned_sharded(rmesh, kplan, kvol)
        _finite("render_planned_sharded", rgb_s)
        _, kloss = tf_fit_step_kernel(rmesh, kplan, params, kvol, ktarget)
        _finite("tf_fit_step_kernel's loss", kloss)
    if seg_plan_ok(kplan, n_devices):
        rgb_z, _ = render_zsharded_kernel(zmesh, kplan, kvol)
        _finite("render_zsharded_kernel", rgb_z)
    if n_devices % 2 == 0 and n_devices >= 4 and seg_plan_ok(kplan, n_devices // 2, 2):
        kbmesh = make_brick_mesh((n_devices // 2, 2, 1), devices=devices)
        _, bloss = tf_fit_step_bricksharded(kbmesh, kplan, params, shard_volume(kbmesh, kvol),
                                            ktarget)
        _finite("tf_fit_step_bricksharded's loss", bloss)
