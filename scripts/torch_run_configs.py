"""Run the five BASELINE configs on the PyTorch port, on one CUDA card, and
print one JSON line per config, each with the card's name and power limit.
Synthetic data stands in for the Richtmyer-Meshkov bricks unless --rm-dir
names them.

  1. 64^3 sphere, dense 256^2 compositing: ``CompositingPlan`` with ``bind``
  2. one 256^3 brick at 512^2: compositing (``CompositingPlan.bind``) and
     the isosurface at 40/255 (``IsosurfacePlan.bind``)
  3. the brick through the kd-tree at tolerances 1, 4 and 8 (2 epochs):
     build, device decode, errors, resident bytes, and a 512^2 frame of
     ``make_plan(pooled=True)``, the compressed-domain render
  4. 8 bricks -> the hashed kd-tree -> its device decode -> 5 TF-fit steps
     through B4 at 1024^2
  5. 4 timesteps through ``TimestepStreamer``: a 1024^2 render from the
     brick-sharded layout (B10 per brick) and a TF-gradient step (B11 per
     brick) per timestep, the (2, 2, 1) bricks all on the one card

Counterpart of ``scripts/run_configs.py`` (the JAX package's), with its
arguments and volumes: ``--small`` for CI sizes, otherwise a 256^3 brick
and 64^3 bricks (a 128^3 volume) for configs 4 and 5.  Config 3 times the
kernel path, not the plain render that ``run_configs.py:149`` times.  With
``--rm-dir`` configs 2 and 3 take brick 0 of timestep 273 and configs 4 and
5 the first 8 bricks of the row (an (8, 1, 1) load, 2048x256x128): the JAX
script's 2x2x2 load of the full grid places bricks outside the load and
fails.

Usage (on a machine with a CUDA card, from the repository's root):
    python3 scripts/torch_run_configs.py [--small] [--rm-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.codecs import kdtree as K
from volumerenderer_tpu_torch.io.bricks import (BrickGrid, file_brick_source, load_bricks,
                                                synthetic_brick_source)
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.models import CompressedRenderer
from volumerenderer_tpu_torch.ops.cuda.isosurface_kernel import IsosurfacePlan
from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import CompositingPlan

TIMESTEPS = [270, 271, 272, 273]


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def timed(fn):
    """Seconds of one call of ``fn`` after a warm call, by the host clock
    around work that ends in a device sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def emit(config, gpu, **kv):
    print(json.dumps({"config": config, **kv, "gpu": gpu}), flush=True)


def config1(dev, gpu):
    vol = as_normalized_volume(sphere_volume((64, 64, 64)), device=dev)
    rays = generate_rays(Camera(width=256, height=256), device=dev)
    plan = CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (64, 64, 64))
    bound = plan.bind(vol)
    bound = bound if bound.has_empty else None
    dt, _ = timed(lambda: plan.render(vol, bound=bound))
    emit(1, gpu, rays_per_s=256 * 256 / dt, seconds=dt, path="kernel",
         bound=bound is not None)


def config2(dev, gpu, brick):
    vol = as_normalized_volume(brick, device=dev)
    Z, Y, X = vol.shape
    rays = generate_rays(Camera(width=512, height=512), device=dev)
    cplan = CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    cbound = cplan.bind(vol)
    cbound = cbound if cbound.has_empty else None
    dt_c, _ = timed(lambda: cplan.render(vol, bound=cbound))
    iplan = IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    ibound = iplan.bind(vol, 40.0 / 255.0)
    dt_i, _ = timed(lambda: iplan.render(vol, 40.0 / 255.0, bound=ibound))
    emit(2, gpu, compositing_rays_per_s=512 * 512 / dt_c, compositing_path="kernel",
         compositing_bound=cbound is not None, isosurface_rays_per_s=512 * 512 / dt_i,
         isosurface_path="kernel", isosurface_bound=True)


def config3(dev, gpu, brick):
    rays = generate_rays(Camera(width=512, height=512), device=dev)
    for tol in (1, 4, 8):
        t0 = time.perf_counter()
        tree = K.build(brick, tolerance=tol, max_epochs=2)
        build_s = time.perf_counter() - t0
        r = CompressedRenderer(tree, dev)
        t0 = time.perf_counter()
        dec = r.volume_at()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        err = np.abs(dec.cpu().numpy().astype(np.float64) * 255.0 - brick.astype(np.float64))
        t0 = time.perf_counter()
        frame = r.make_plan(rays, pooled=True)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        dt, _ = timed(frame)
        pool, smap = r.slab_pool_at()
        resident = (tree.num_active_nodes + 3) // 4 + pool.nbytes + smap.nbytes
        emit(3, gpu, tolerance=tol, build_s=build_s, decode="device", decode_s=decode_s,
             bits_per_voxel=2 * tree.num_active_nodes / brick.size,
             max_err=float(err.max()), mean_err=float(err.mean()),
             resident_bytes=int(resident), resident_vs_dense_u8=float(resident / brick.size),
             plan_s=plan_s, rays_per_s=512 * 512 / dt, path="make_plan(pooled=True)")


def config4(dev, gpu, source, grid, load, width=1024):
    from volumerenderer_tpu_torch.codecs import hashed as HC
    from volumerenderer_tpu_torch.ops.cuda.tf_kernel import make_render_tf_kernel, tf_fit_step_fast

    multi = load_bricks(source, grid, 8, *load, 273)
    t0 = time.perf_counter()
    tree = HC.build(multi, tolerance=4)
    build_s = time.perf_counter() - t0
    dtree = HC.to_device_hashed(tree, dev)
    t0 = time.perf_counter()
    vol = as_normalized_volume(HC.level_cut_device_hashed(tree, dtree))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    err = np.abs(vol.cpu().numpy().astype(np.float64) * 255.0 - multi.astype(np.float64))
    rays = generate_rays(Camera(width=width, height=width), device=dev)
    Z, Y, X = vol.shape
    plan = CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    f = make_render_tf_kernel(plan)
    target = torch.full((width, width, 3), 0.5, device=dev)
    params, losses = TFParams.reference(dev), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        params, loss = tf_fit_step_fast(f, params, vol, target, lr=0.05)
        losses.append(float(loss))
    fit_s = (time.perf_counter() - t0) / 5
    emit(4, gpu, hashed_build_s=build_s, hashed_device_decode_s=decode_s,
         hashed_max_err=float(err.max()), tf_fit_losses=losses, fit_step_s=fit_s,
         fit_path="kernel", improved=bool(losses[-1] < losses[0]))


def config5(dev, gpu, source, grid, load, width=1024):
    from volumerenderer_tpu_torch.io.streaming import TimestepStreamer
    from volumerenderer_tpu_torch.parallel.bricks import make_brick_mesh, shard_volume
    from volumerenderer_tpu_torch.parallel.kernel_sharded import (render_bricksharded_kernel,
                                                                  tf_fit_step_bricksharded)

    streamer = TimestepStreamer(source, grid, TIMESTEPS, num_bricks=8, I=load[0], J=load[1],
                                K_bricks=load[2], tolerance=4, max_epochs=1, prefetch=2,
                                device=dev)
    rays = generate_rays(Camera(width=width, height=width), device=dev)
    X, Y, Z = grid.volume_dims(*load)
    plan = CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    mesh = make_brick_mesh((2, 2, 1), devices=[dev] * 4)
    target = torch.full((width, width, 3), 0.5, device=dev)
    params, losses = TFParams.reference(dev), []
    t0 = time.perf_counter()
    for _, renderer in streamer:
        sv = shard_volume(mesh, renderer.volume_at())
        rgb, _ = render_bricksharded_kernel(mesh, plan, sv)
        float(rgb.sum())
        params, loss = tf_fit_step_bricksharded(mesh, plan, params, sv, target, lr=0.05)
        losses.append(float(loss))
    dt = time.perf_counter() - t0
    if not all(np.isfinite(losses)):
        raise AssertionError(f"config 5: losses {losses}")
    emit(5, gpu, timesteps=len(losses), total_s=dt, per_timestep_s=dt / len(losses),
         width=width, grad_losses=losses, grad_allreduce=True,
         layout=f"bricksharded_kernel(2,2,1) on {dev}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rm-dir", default=None, help="Richtmyer-Meshkov all_bricks dir")
    ap.add_argument("--small", action="store_true", help="CI-sized volumes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_run_configs: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = card()

    load = (2, 2, 2)
    width4 = 1024
    if args.small:
        brick = turbulence_volume((64, 64, 64), seed=273)
        grid = BrickGrid(brick_dims=(16, 16, 16), grid=(2, 2, 2))
        src = synthetic_brick_source(grid)
        width4 = 128
    elif args.rm_dir:
        grid = BrickGrid()
        src = file_brick_source(args.rm_dir, grid)
        brick = load_bricks(src, grid, 1, 1, 1, 1, 273)
        load = (8, 1, 1)
    else:
        brick = turbulence_volume((256, 256, 256), seed=273)
        grid = BrickGrid(brick_dims=(64, 64, 64), grid=(2, 2, 2))
        src = synthetic_brick_source(grid)

    config1(dev, gpu)
    config2(dev, gpu, brick)
    config3(dev, gpu, brick)
    config4(dev, gpu, src, grid, load, width=width4)
    config5(dev, gpu, src, grid, load, width=width4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
