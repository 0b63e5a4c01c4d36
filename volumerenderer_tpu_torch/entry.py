"""Entry points: the flagship forward step and a dry run of every
sharded layout at small shapes.

Counterpart of ``__graft_entry__.py``: ``entry()`` (:15-56) returns the
1024^2 compositing render of the normalized 256^3 sphere as ``(fn,
example_args)``; ``dryrun_multichip`` (:59-174) runs each layout once.  On
the card ``fn`` is one launch of the compositing march B1 over a
``plan_compositing`` plan's tensors, the transfer in its epilogue (JAX's
``_launch`` -> ``_untile`` -> ``apply_reference_transfer``); on the CPU,
asked for with ``device="cpu"``, it is the plain ``render_compositing`` (JAX's
fallback branch).  JAX's interpret-mode patch has no counterpart: on CPU
devices each kernel wrapper runs its plain version.

Usage (on a machine with a CUDA card):  python3 -m volumerenderer_tpu_torch.entry
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .camera import Camera, generate_rays
from .diff.transfer import TFParams
from .io.synthetic import sphere_volume
from .models import plan_compositing
from .ops.cuda.raycast_kernel import composite_march_cuda
from .ops.raycast import render_compositing
from .ops.sampling import as_normalized_volume
from .parallel.bricks import make_brick_mesh, render_bricksharded, shard_volume
from .parallel.context import make_z_mesh, render_zsharded
from .parallel.kernel_sharded import (plan_shardable, render_planned_sharded,
                                      render_zsharded_kernel, seg_plan_ok,
                                      tf_fit_step_bricksharded, tf_fit_step_kernel)
from .parallel.sharding import DeviceMesh, default_devices, make_mesh, tf_fit_step

__all__ = ["entry", "dryrun_multichip"]


def _entry(size: tuple[int, int], dims: tuple[int, int, int], device):
    """``entry()`` at an image of ``size`` = (W, H) pixels and a sphere of
    ``dims`` = (Z, Y, X) voxels (the tests' small shapes)."""
    device = torch.device(device)
    width, height = size
    vol = as_normalized_volume(sphere_volume(dims), device=device)
    rays = generate_rays(Camera(width=width, height=height), device=device)
    if device.type == "cuda":
        Z, Y, X = vol.shape
        plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))

        def fn(volume, entry_uv, dir_step, hit):
            rgb, _ = composite_march_cuda(volume, entry_uv, dir_step, hit, plan.max_samples,
                                          plan.wrap)
            return rgb

        return fn, (vol, plan.entry_uv, plan.dir_step, plan.hit)

    def fn(volume, entry_uv, direction, hit):
        rgb, _ = render_compositing(volume, entry_uv, direction, hit)
        return rgb

    return fn, (vol, rays.entry_uv, rays.direction, rays.hit)


def entry(device="cuda"):
    """The flagship forward step: ``(fn, example_args)`` with ``fn(*example_args)``
    the (1024, 1024, 3) rgb image of ``sphere_volume((256, 256, 256))``,
    normalized, from the default ``Camera(width=1024, height=1024)``.

    On the card (the default) the arguments are the volume and a
    ``plan_compositing`` plan's ``entry_uv``, ``dir_step`` and ``hit``, and
    ``fn`` is one launch of B1 (``composite_march_cuda`` on the float32
    volume, the transfer in its epilogue), what ``CompositingPlan.render`` launches.  With
    ``device="cpu"`` the arguments are the volume and the rays, and ``fn`` is
    the plain ``render_compositing``.  Without a card, and without
    ``device="cpu"``, it raises torch's own "no CUDA" error, as every entry
    point of the port does."""
    return _entry((1024, 1024), (256, 256, 256), device)


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


def main() -> int:
    fn, args = entry()
    rgb = fn(*args)
    torch.cuda.synchronize()
    if tuple(rgb.shape) != (1024, 1024, 3) or not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"entry(): rgb {tuple(rgb.shape)}, expected finite (1024, 1024, 3)")
    print(f"entry() ran OK on {torch.cuda.get_device_name(0)}: rgb {tuple(rgb.shape)}, "
          f"sum {float(rgb.sum()):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
