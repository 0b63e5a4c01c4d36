#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two render paths over a 1024x1024 image of a 256^3 8-bit
volume, planned once per camera over a 16-frame orbit, through the entry
points a user calls:

* compositing: ``generate_rays`` -> ``plan_compositing`` ->
  ``CompositingPlan.render`` (kernel ``csrc/composite_march.cu``);
* isosurface, at the volume's median: ``generate_rays`` -> ``IsosurfacePlan``
  -> ``IsosurfacePlan.render`` (kernels ``csrc/iso_march.cu`` and
  ``csrc/iso_shade.cu``).

On the way it builds the three kernels from ``volumerenderer_tpu_torch/csrc``
(one ``nvcc`` each, all at once), holds each against its plain PyTorch
version and the goldens, times both, and checks that each path launched its
kernels once per render.

Usage, from the root of a checkout:  python3 chip_smoke.py

Each phase prints one JSON line (device, build, goldens, parity, main_path,
kernel_timing, layers, launch_count, then iso_goldens, iso_parity,
iso_main_path, iso_timing, iso_layers, iso_launch_count).  Then come the
kernels line, the card's ``nvidia-smi`` name and power limit, and, last,
``{"ok": true, "device": {"platform": "gpu", ...}}``.  The kernels line's
``max_abs_err`` is over the parity cases: |color|, |alpha| for the
compositing march, |t_hit| in steps (-1 for a miss) for the isosurface
march, |rgb| for the shade pass.  Without a CUDA device, or away from the
repository's package, it exits non-zero and prints no result.  Any failed
check raises.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
W = H = 1024
VOLUME = (256, 256, 256)
N_FRAMES = 16
REPS = 3
GOLDEN_RGB, GOLDEN_ALPHA, GOLDEN_TOL = 3667.208252, 3046.968750, 0.02
# kernel vs plain: early-out knife edges (one composite step, pa <= 0.01) may
# flip on an ulp; allow 4 of them per Mpixel, and nothing beyond 1.5e-2
TIGHT, KNIFE_PER_MPX, LOOSE = 1e-5, 4, 1.5e-2
KERNEL_SOURCE = "volumerenderer_tpu_torch/csrc/composite_march.cu"
REPLACES = "volumerenderer_tpu/ops/pallas/raycast_kernel.py:830"
ISO_GOLDEN_RGB, ISO_GOLDEN_TOL, ISO_GOLDEN_HITS = 9185.606445, 0.05, 18
# isosurface kernels vs plain: found and t_hit equal on all but 4 px per
# Mpixel (a crossing test on an ulp); rgb within 1e-4 fed the same hits
# (pow(x, 250) turns one ulp of a dot product into ~250)
ISO_RGB_TOL = 1e-4
ISO_SOURCES = {"iso_march": "volumerenderer_tpu_torch/csrc/iso_march.cu",
               "iso_shade": "volumerenderer_tpu_torch/csrc/iso_shade.cu"}
ISO_REPLACES = {"iso_march": "volumerenderer_tpu/ops/pallas/isosurface_kernel.py:458",
                "iso_shade": "volumerenderer_tpu/ops/pallas/isosurface_kernel.py:1501"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def orbit_camera(Camera, az_deg: float, width: int, height: int):
    """The benchmark's orbit: the default eye (0, 0, -0.75) rotated about +y,
    looking at the volume's center."""
    a = math.radians(az_deg)
    return Camera(width=width, height=height,
                  position=(0.75 * math.sin(a), 0.0, -0.75 * math.cos(a)),
                  front=(-math.sin(a), 0.0, math.cos(a)))


def import_port():
    sys.path.insert(0, str(HERE))
    import volumerenderer_tpu_torch as port

    where = Path(port.__file__).resolve().parent.parent
    if where != HERE:
        raise ImportError(f"volumerenderer_tpu_torch imported from {where}, not {HERE}")
    return port


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(kernel_out, plain_out, n_px: int) -> dict:
    """Largest |kernel - plain| over color and alpha, and how many pixels
    exceed the tight bar; raises if the bars are missed."""
    d = None
    for k, p in zip(kernel_out, plain_out):
        dk = (k - p).abs()
        d = dk if d is None else torch.maximum(d, dk)
    max_abs = float(d.max())
    n_over = int((d > TIGHT).sum())
    allowed = KNIFE_PER_MPX * n_px / 2**20
    if n_over > allowed or max_abs > LOOSE:
        raise AssertionError(f"kernel vs plain: {n_over} px beyond {TIGHT} (allowed "
                             f"{allowed:g}), max |d| {max_abs} (bar {LOOSE})")
    return {"max_abs_err": max_abs, "px_beyond_1e-5": n_over, "px_allowed": allowed}


def time_ms(fn, reps: int = REPS) -> float:
    """Min over ``reps`` of one call of ``fn`` after a warm call, in ms (CUDA
    events around work on the current stream)."""
    fn()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def sweep_seconds(fn) -> float:
    """Min over REPS of one call of ``fn`` after a warm call, in seconds
    (host clock; ``fn`` ends in a host read of a device sum)."""
    fn()
    best = math.inf
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run_isosurface(dev, smi: str, turb, sphere, cameras, bundles) -> list:
    """The isosurface phases; returns the kernels line's two entries."""
    from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
    from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
    from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import quantize_u8
    from volumerenderer_tpu_torch.ops.isosurface import (iso_march_steps, render_isosurface,
                                                         shade_hits)

    # the isosurface golden of tests/test_goldens.py, through both kernels
    vol = as_normalized_volume(turbulence_volume((32, 32, 32), seed=99), device=dev)
    rays = generate_rays(Camera(width=64, height=48), device=dev)
    rgb, found = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit,
                                   (32, 32, 32)).render(vol)
    total, hits = float(rgb.sum()), int(found.sum())
    if abs(total - ISO_GOLDEN_RGB) >= ISO_GOLDEN_TOL or hits != ISO_GOLDEN_HITS:
        raise AssertionError(f"iso golden through the kernels: sum {total}, {hits} hits; "
                             f"expected {ISO_GOLDEN_RGB} within {ISO_GOLDEN_TOL}, "
                             f"{ISO_GOLDEN_HITS} hits")
    emit({"phase": "iso_goldens", "sum_rgb": total, "hits": hits, "tol": ISO_GOLDEN_TOL})

    # each kernel vs its plain version on the same inputs; the shade pass of
    # both is fed the kernel march's hits
    iso_med = IK.volume_median(turb)
    cases = [("entry_sphere", sphere, Camera(width=W, height=H), 0.5, "clamp"),
             ("orbit_frame0", turb, cameras[0], iso_med, "clamp"),
             ("orbit_frame15", turb, cameras[-1], iso_med, "clamp"),
             ("iso40_frame0", turb, cameras[0], 40.0 / 255.0, "clamp"),
             ("repeat_128", turb, orbit_camera(Camera, 30.0, 128, 128), iso_med, "repeat")]
    err = {"iso_march": 0.0, "iso_shade": 0.0}
    for name, v, cam, iso, wrap in cases:
        rays = generate_rays(cam, device=dev)
        Z, Y, X = v.shape
        plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), wrap=wrap)
        vol_u8 = quantize_u8(v)
        plain_vol = as_normalized_volume(vol_u8)
        found_k, t_hit_k = IK.iso_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit,
                                             iso, plan.max_samples, wrap)
        rgb_k = IK.iso_shade_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.direction,
                                  found_k, t_hit_k, iso, wrap)
        found_p, t_hit_p = iso_march_steps(plain_vol, plan.entry_uv, plan.dir_step,
                                           plan.hit.bool(), iso, plan.max_samples, wrap)
        rgb_p = shade_hits(plain_vol, plan.entry_uv, plan.dir_step, plan.direction, found_k,
                           t_hit_k, iso, wrap)
        torch.cuda.synchronize()
        n_px = cam.width * cam.height
        px_differ = int(((found_k != found_p) | (t_hit_k != t_hit_p)).sum())
        t_hit_err = float((t_hit_k - t_hit_p).abs().max())
        rgb_err = float((rgb_k - rgb_p).abs().max())
        allowed = KNIFE_PER_MPX * n_px / 2**20
        if px_differ > allowed or rgb_err > ISO_RGB_TOL:
            raise AssertionError(f"iso {name}: {px_differ} px differ in found/t_hit (allowed "
                                 f"{allowed:g}), rgb max |d| {rgb_err} (bar {ISO_RGB_TOL})")
        err["iso_march"] = max(err["iso_march"], t_hit_err)
        err["iso_shade"] = max(err["iso_shade"], rgb_err)
        emit({"phase": "iso_parity", "case": name, "wrap": wrap, "iso": iso,
              "hw": [cam.height, cam.width], "hits_kernel": int(found_k.sum()),
              "hits_plain": int(found_p.sum()), "px_differ_found_t_hit": px_differ,
              "px_allowed": allowed, "t_hit_max_abs_err": t_hit_err,
              "rgb_max_abs_err": rgb_err,
              "rgb_px_beyond_1e-6": int(((rgb_k - rgb_p).abs() > 1e-6).sum())})

    # the main path: the 16-frame orbit at the volume's median, plans built
    # once; min of REPS sweeps after a warm sweep.  The launch counts cover
    # exactly this run.
    IK.iso_march_cuda.launches = 0
    IK.iso_shade_cuda.launches = 0
    renders = 0
    plans = [IK.IsosurfacePlan(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]
    last = {}

    def kernel_sweep():
        nonlocal renders
        acc = torch.zeros((), device=dev)
        for plan in plans:
            last["rgb"], last["found"] = plan.render(turb, iso_med)
            acc = acc + last["rgb"].sum()
            renders += 1
        return float(acc)

    def plain_sweep():
        acc = torch.zeros((), device=dev)
        for r in bundles:
            rgb, _ = render_isosurface(turb, r.entry_uv, r.direction, r.hit, iso_med)
            acc = acc + rgb.sum()
        return float(acc)

    kernel_sweep_s = sweep_seconds(kernel_sweep)
    launches = {"iso_march": IK.iso_march_cuda.launches, "iso_shade": IK.iso_shade_cuda.launches}
    plain_sweep_s = sweep_seconds(plain_sweep)
    rgb, found = last["rgb"], last["found"]
    if rgb.shape != (H, W, 3) or found.shape != (H, W) or not bool(torch.isfinite(rgb).all()) \
            or not bool(((rgb >= 0) & (rgb <= 1)).all()) or not 0 < int(found.sum()) < H * W:
        raise AssertionError(f"iso main path output: rgb {tuple(rgb.shape)}, found "
                             f"{tuple(found.shape)} with {int(found.sum())} hits; "
                             f"finite/in-range/hit check failed")
    emit({"phase": "iso_main_path", "metric": "iso_rays_per_s_per_chip_1024sq_256cube",
          "iso": iso_med, "kernel_rays_per_s": W * H / (kernel_sweep_s / N_FRAMES),
          "plain_rays_per_s": W * H / (plain_sweep_s / N_FRAMES),
          "kernel_ms_per_frame": 1e3 * kernel_sweep_s / N_FRAMES,
          "plain_ms_per_frame": 1e3 * plain_sweep_s / N_FRAMES,
          "hits_last_frame": int(found.sum()), "frames": N_FRAMES, "reps": REPS, "gpu": smi})

    # per-launch times of each kernel and its plain version over the orbit,
    # then frame 0 split into its layers
    turb_u8 = quantize_u8(turb)
    turb_plain = as_normalized_volume(turb_u8)
    hits = [IK.iso_march_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit, iso_med) for p in plans]
    ms = {
        "iso_march": time_ms(lambda: [IK.iso_march_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit,
                                                        iso_med) for p in plans]) / N_FRAMES,
        "iso_shade": time_ms(lambda: [IK.iso_shade_cuda(turb_u8, p.entry_uv, p.dir_step,
                                                        p.direction, f, t, iso_med)
                                      for p, (f, t) in zip(plans, hits)]) / N_FRAMES}
    plain_ms = {
        "iso_march": time_ms(lambda: [iso_march_steps(turb_plain, p.entry_uv, p.dir_step,
                                                      p.hit.bool(), iso_med)
                                      for p in plans]) / N_FRAMES,
        "iso_shade": time_ms(lambda: [shade_hits(turb_plain, p.entry_uv, p.dir_step,
                                                 p.direction, f, t, iso_med)
                                      for p, (f, t) in zip(plans, hits)]) / N_FRAMES}
    emit({"phase": "iso_timing", "shape": [H, W], "volume": list(VOLUME), "iso": iso_med,
          "frames": N_FRAMES, "kernel_ms_per_launch": ms, "plain_ms_per_launch": plain_ms,
          "gpu": smi})
    rays0, plan0, (f0, t0) = bundles[0], plans[0], hits[0]
    emit({"phase": "iso_layers", "ms": {
        "volume_median": time_ms(lambda: IK.volume_median(turb)),
        "plan": time_ms(lambda: IK.IsosurfacePlan(rays0.entry_uv, rays0.direction, rays0.hit,
                                                  VOLUME[::-1])),
        "quantize_u8": time_ms(lambda: quantize_u8(turb)),
        "march_kernel": time_ms(lambda: IK.iso_march_cuda(turb_u8, plan0.entry_uv,
                                                          plan0.dir_step, plan0.hit, iso_med)),
        "shade_kernel": time_ms(lambda: IK.iso_shade_cuda(turb_u8, plan0.entry_uv,
                                                          plan0.dir_step, plan0.direction,
                                                          f0, t0, iso_med))},
        "hits_frame0": int(f0.sum()), "gpu": smi})

    # the main path went through both kernels, once per render each
    if renders == 0 or any(n != renders for n in launches.values()):
        raise AssertionError(f"isosurface kernels launched {launches} times for {renders} "
                             f"renders")
    emit({"phase": "iso_launch_count", **launches, "renders": renders})
    return [{"name": name, "route": "cuda", "source": ISO_SOURCES[name],
             "replaces": ISO_REPLACES[name], "launches": launches[name],
             "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name]}
            for name in ("iso_march", "iso_shade")]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        port = import_port()
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 1
    from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
    from volumerenderer_tpu_torch.models import plan_compositing, reference_renderer
    from volumerenderer_tpu_torch.ops.cuda import _build
    from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.raycast import composite_march_steps

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device
    smi = nvidia_smi()
    gpu = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "gpu": gpu,
          "count": torch.cuda.device_count(), "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "port": port.__version__})

    # 2. build the kernels from the checkout's sources, one nvcc each, at once
    t0 = time.perf_counter()
    _build.load_many(["composite_march", "iso_march", "iso_shade"])
    libraries = {"composite_march": RK.load_kernel(), **IK.load_kernels()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": {
        name: {"nvcc_seconds": built.build_seconds,
               "library": str(built.path.relative_to(HERE)),
               "ptxas": [ln.strip() for ln in built.log.splitlines()
                         if "registers" in ln or "spill" in ln]}
        for name, built in libraries.items()}})

    # 3. the compositing goldens, through the kernel
    vol = as_normalized_volume(turbulence_volume((32, 32, 32), seed=99), device=dev)
    rays = generate_rays(Camera(width=64, height=48), device=dev)
    Z, Y, X = vol.shape
    rgb, alpha = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z)).render(vol)
    sums = (float(rgb.sum()), float(alpha.sum()))
    if abs(sums[0] - GOLDEN_RGB) >= GOLDEN_TOL or abs(sums[1] - GOLDEN_ALPHA) >= GOLDEN_TOL:
        raise AssertionError(f"goldens through the kernel: sums {sums}, expected "
                             f"({GOLDEN_RGB}, {GOLDEN_ALPHA}) within {GOLDEN_TOL}")
    emit({"phase": "goldens", "sum_rgb": sums[0], "sum_alpha": sums[1], "tol": GOLDEN_TOL})

    # 4. kernel vs plain march on the card, same inputs, at the main path's shapes
    sphere = as_normalized_volume(sphere_volume(VOLUME), device=dev)
    turb = as_normalized_volume(turbulence_volume(VOLUME, seed=0), device=dev)
    cases = [("entry_sphere", sphere, Camera(width=W, height=H), "clamp"),
             ("orbit_frame0", turb, orbit_camera(Camera, 0.0, W, H), "clamp"),
             ("orbit_frame15", turb, orbit_camera(Camera, 2.0 * (N_FRAMES - 1), W, H), "clamp"),
             ("repeat_128", turb, orbit_camera(Camera, 30.0, 128, 128), "repeat")]
    max_abs_err = 0.0
    for name, v, cam, wrap in cases:
        rays = generate_rays(cam, device=dev)
        Z, Y, X = v.shape
        plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
        vol_u8 = RK.quantize_u8(v)
        k = RK.composite_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit,
                                    plan.max_samples, wrap)
        p = composite_march_steps(as_normalized_volume(vol_u8), plan.entry_uv, plan.dir_step,
                                  plan.hit.bool(), plan.max_samples, wrap)
        torch.cuda.synchronize()
        res = compare(k, p, cam.width * cam.height)
        max_abs_err = max(max_abs_err, res["max_abs_err"])
        emit({"phase": "parity", "case": name, "wrap": wrap, "hw": [cam.height, cam.width],
              "alpha_sum_kernel": float(k[1].sum()), "alpha_sum_plain": float(p[1].sum()), **res})

    # 5. the main path, as a user drives it: camera -> rays -> plan (once per
    # camera) -> render, over the 16-frame orbit; min of REPS sweeps after a
    # warm sweep.  The launch count covers exactly this run.
    RK.composite_march_cuda.launches = 0
    renders = 0
    cameras = [orbit_camera(Camera, 2.0 * i, W, H) for i in range(N_FRAMES)]
    bundles = [generate_rays(cam, device=dev) for cam in cameras]
    plans = [plan_compositing(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]
    last = {}

    def kernel_sweep():
        nonlocal renders
        acc = torch.zeros((), device=dev)
        for plan in plans:
            last["rgb"], last["alpha"] = plan.render(turb)
            acc = acc + last["rgb"].sum()
            renders += 1
        return float(acc)

    def plain_sweep():
        render = reference_renderer()
        acc = torch.zeros((), device=dev)
        for r in bundles:
            rgb, _ = render(turb, r.entry_uv, r.direction, r.hit)
            acc = acc + rgb.sum()
        return float(acc)

    kernel_sweep_s = sweep_seconds(kernel_sweep)
    launches = RK.composite_march_cuda.launches
    plain_sweep_s = sweep_seconds(plain_sweep)
    rgb, alpha = last["rgb"], last["alpha"]
    if rgb.shape != (H, W, 3) or alpha.shape != (H, W) or not bool(torch.isfinite(rgb).all()) \
            or not bool(((alpha >= 0) & (alpha <= 1)).all()):
        raise AssertionError(f"main path output: rgb {tuple(rgb.shape)}, alpha "
                             f"{tuple(alpha.shape)}, finite/in-range check failed")
    emit({"phase": "main_path", "metric": "rays_per_s_per_chip_1024sq_256cube",
          "kernel_rays_per_s": W * H / (kernel_sweep_s / N_FRAMES),
          "plain_rays_per_s": W * H / (plain_sweep_s / N_FRAMES),
          "kernel_ms_per_frame": 1e3 * kernel_sweep_s / N_FRAMES,
          "plain_ms_per_frame": 1e3 * plain_sweep_s / N_FRAMES,
          "frames": N_FRAMES, "reps": REPS, "gpu": smi})

    # per-launch times of the kernel and its plain version on the orbit's
    # inputs, then each layer of one frame alone (orbit frame 0)
    turb_u8 = RK.quantize_u8(turb)
    turb_plain = as_normalized_volume(turb_u8)
    kernel_ms = time_ms(lambda: [RK.composite_march_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit)
                                 for p in plans]) / N_FRAMES
    plain_ms = time_ms(lambda: [composite_march_steps(turb_plain, p.entry_uv, p.dir_step,
                                                      p.hit.bool()) for p in plans]) / N_FRAMES
    emit({"phase": "kernel_timing", "shape": [H, W], "volume": list(VOLUME),
          "frames": N_FRAMES, "kernel_ms_per_launch": kernel_ms,
          "plain_ms_per_launch": plain_ms, "gpu": smi})
    cam0, rays0, plan0 = cameras[0], bundles[0], plans[0]
    c0, a0 = RK.composite_march_cuda(turb_u8, plan0.entry_uv, plan0.dir_step, plan0.hit)
    emit({"phase": "layers", "ms": {
        "generate_rays": time_ms(lambda: generate_rays(cam0, device=dev)),
        "plan": time_ms(lambda: plan_compositing(rays0.entry_uv, rays0.direction, rays0.hit,
                                                 VOLUME[::-1])),
        "quantize_u8": time_ms(lambda: RK.quantize_u8(turb)),
        "march_kernel": time_ms(lambda: RK.composite_march_cuda(turb_u8, plan0.entry_uv,
                                                                plan0.dir_step, plan0.hit)),
        "transfer": time_ms(lambda: RK.apply_reference_transfer(c0, a0))}, "gpu": smi})

    # 6. the main path went through the kernel, once per render
    if launches == 0 or launches != renders:
        raise AssertionError(f"composite_march launched {launches} times for {renders} renders")
    emit({"phase": "launch_count", "composite_march": launches, "renders": renders})

    iso_kernels = run_isosurface(dev, smi, turb, sphere, cameras, bundles)

    emit({"kernels": [{"name": "composite_march", "route": "cuda", "source": KERNEL_SOURCE,
                       "replaces": REPLACES, "launches": launches,
                       "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms},
                      *iso_kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
