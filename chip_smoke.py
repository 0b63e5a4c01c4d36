#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's render and gradient paths over a 1024x1024 image of a
256^3 8-bit volume, planned once per camera, through the entry points a user
calls:

* compositing, over a 16-frame orbit: ``generate_rays`` ->
  ``plan_compositing`` -> ``CompositingPlan.render``: one launch of
  ``csrc/composite_march.cu`` (B1) per frame, on the float32 volume, each tap
  quantized to 8 bits as it is read, the transfer in its epilogue;
* isosurface at the volume's median, over the same orbit: ``generate_rays``
  -> ``IsosurfacePlan`` -> ``IsosurfacePlan.bind`` (once for the volume and
  isovalue, shared by the 16 plans) -> ``IsosurfacePlan.render(..., bound=)``
  (kernels ``csrc/iso_march.cu``, skipping exactly, and
  ``csrc/iso_shade.cu``), with the bind inside the sweep and outside it,
  and the same unbound;
* gradients, on orbit frame 0: the config-4 TF fit, ``plan_compositing`` ->
  ``make_render_tf_kernel`` -> ``tf_fit_step_fast`` x 5, and a voxel-grad
  step, ``make_render_tf_voxel`` -> MSE loss -> ``torch.autograd.grad`` of
  the TF params and the volume (kernels ``csrc/tf_march.cu`` and
  ``csrc/voxel_grad.cu``), timed against one forward frame;
* the compressed domain, over the same orbit: ``codecs.kdtree.build`` of the
  256^3 turbulence on the host (tolerance 4, 2 epochs; the Δ seeding in
  ``csrc/kdtree_seed.cu``) -> ``CompressedRenderer(tree, device)`` ->
  ``make_plan(rays, mode=..., pooled=True)`` -> render: the packed tree on
  the card, one chunked level-cut decode, the sparse slab pools, and the
  pooled marches (B7 compositing; B8 and the pooled shade for the
  isosurface), plus ``render_pooled`` on the dense turbulence's pools for
  the pooled metrics (B6, B7, B8, B9);
* the sharded layouts, over the same orbit, the shards spread round-robin
  over the host's cards: ``make_z_mesh(4)`` / ``make_brick_mesh((2, 2, 1))``
  -> ``shard_volume`` -> ``render_zsharded_kernel`` /
  ``render_bricksharded_kernel`` per frame (the segment march
  ``csrc/seg_march.cu`` B10 once per shard, from each shard's entry table,
  built by that file's table kernel at a camera's first frame and cached on
  its plan), ``tf_fit_step_bricksharded`` x 5 (B11 once per brick), and the
  row-sharded ``render_planned_sharded``,
  ``tf_fit_step_kernel`` and ``voxel_fit_step_kernel`` on ``make_mesh(4)``
  (B1, B4 and B5 once per row shard).

On the way it builds the kernels from ``volumerenderer_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version and the goldens, times both, and checks that each path launched its
kernels once per render, forward or backward.

Usage, from the root of a checkout:  python3 chip_smoke.py

Each phase prints one JSON line (device, build, goldens, parity, main_path,
kernel_timing, layers, launch_count, main_path_profile, b1_warps,
b1_routes, then iso_goldens, iso_parity,
iso_main_path, iso_timing, iso_layers, iso_launch_count, then tf_parity,
vg_parity, grad_reference, grad_main_path, grad_timing, grad_layers,
vg_tile, grad_launch_count, then codec, decode, pools, pooled_parity,
pooled_main_path, compressed_main_path, pooled_timing, pooled_launch_count,
then sharded_parity, sharded_main_path, sharded_fit, sharded_rows,
sharded_timing, seg_starts, sharded_layers, sharded_launch_count).
Then come the kernels line, the card's ``nvidia-smi`` name and power limit,
and, last, ``{"ok": true, "device": {"platform": "gpu", ...}}``.  The
kernels line's ``max_abs_err`` is over the parity cases, kernel against
plain version: |rgb| (B1) or |color|, and |alpha| for the compositing
marches, |t_hit| in steps (-1 for a miss) for the isosurface marches, |rgb|
for the shade passes, the largest |d| of the seven images for the TF march,
|g_vol| for the voxel-gradient march, |position| and |i0| of the segment
entry table.  Without a CUDA device, or away from the repository's package,
it exits non-zero and prints no result.  Any failed check raises.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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
# B4 vs plain: color and alpha at the compositing bars above; the five sums
# within 1e-6 relative to max(1, |plain|) on all but the same 4 px per Mpixel.
# B5 vs plain: max |d| within 2e-5 of max |g| (the atomics add in no fixed
# order); |sum(g_vol) - sum(g_s)| over the alive steps within 1e-5 of sum |g_s|.
TF_SUMS_REL, VG_REL, VG_CONSERVATION = 1e-6, 2e-5, 1e-5
FIT_STEPS, FIT_LR = 5, 0.05
GRAD_SOURCES = {"tf_march": "volumerenderer_tpu_torch/csrc/tf_march.cu",
                "voxel_grad": "volumerenderer_tpu_torch/csrc/voxel_grad.cu"}
GRAD_REPLACES = {"tf_march": "volumerenderer_tpu/ops/pallas/tf_kernel.py:222",
                 "voxel_grad": "volumerenderer_tpu/ops/pallas/voxel_grad_kernel.py:268"}
# the compressed domain: config 3's middle tolerance (scripts/run_configs.py)
TREE_TOLERANCE, TREE_EPOCHS = 4, 2
POOLED_SOURCES = {"composite_march_pooled_narrow": KERNEL_SOURCE,
                  "composite_march_pooled_pair16": KERNEL_SOURCE,
                  "iso_march_pooled_narrow": ISO_SOURCES["iso_march"],
                  "iso_march_pooled_pair16": ISO_SOURCES["iso_march"],
                  "iso_shade_pooled": ISO_SOURCES["iso_shade"]}
POOLED_REPLACES = {
    "composite_march_pooled_narrow": "volumerenderer_tpu/ops/pallas/raycast_kernel.py:779",
    "composite_march_pooled_pair16": "volumerenderer_tpu/ops/pallas/raycast_kernel.py:891",
    "iso_march_pooled_narrow": "volumerenderer_tpu/ops/pallas/isosurface_kernel.py:531",
    "iso_march_pooled_pair16": "volumerenderer_tpu/ops/pallas/isosurface_kernel.py:731",
    # B3's body on the pool; the JAX pooled render shades in jnp
    # (isosurface_kernel.py:1242, _shade_pooled)
    "iso_shade_pooled": "volumerenderer_tpu/ops/pallas/isosurface_kernel.py:1501"}
# the volume-sharded layouts: z-slabs (n = 4) and (bz, by, bx) = (2, 2, 1) bricks
SEG_SOURCE = "volumerenderer_tpu_torch/csrc/seg_march.cu"
SEG_REPLACES = {"seg_march": "volumerenderer_tpu/ops/pallas/seg_kernel.py:235",
                "seg_tf_march": "volumerenderer_tpu/ops/pallas/seg_kernel.py:469",
                # build_word_table_seg: the TPU word table (group skip, DMA windows)
                "seg_entry_table": "volumerenderer_tpu/ops/pallas/seg_kernel.py:553"}
Z_SHARDS, BRICKS = 4, (2, 2, 1)
NON_REFERENCE_TF = (0.45, 0.9, 0.05, [-0.8, 0.6, 0.3], [0.9, 0.2, 0.4])

# The bound of a launch: the larger of its bytes (each input read once, each
# output written once) over the card's memory rate and its float32
# operations over the peak rate outside the tensor cores (NVIDIA's H100 SXM
# data sheet, at 700 W).  Operations per step, from each kernel's arithmetic:
# a trilinear sample 41 (texel coordinates 6, floors 3, fractions 3, byte
# scales 8, seven lerps 21); a position step 3; compositing 6; the TF sums
# 16 more; B1 and B4 on the float32 volume quantize each of the 8 taps
# (max, min, product, round: 4 each) and B1 writes 1 - c once per ray; the
# iso crossing test and lookahead step 5; the segment anchor
# test 6 (a segment step before the sample: a position step and the anchor
# test, 9); the voxel gradient's replayed step, cotangent, tap weights and 8
# atomic adds 94 in all; the shade 3 per rebuilt step and per hit 4
# bisections (47), 6 normal taps (44) and 60 for the Phong terms.  A bound
# iso march classifies every sample's block (texel coordinates 6, floors 3;
# like the sampler's index math, its integer clamps, shifts and 2-byte load
# are not counted) and gathers only in a mixed block: a gathered sample 49 +
# 9, a skipped one 49 - 41 + 9.
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
QUANTIZE_OPS_PER_TAP, TRANSFER_OPS_PER_RAY = 4, 1
OPS_PER_STEP = {"composite": 50, "tf": 66, "voxel_grad": 94, "iso": 49, "seg_walk": 9,
                "seg_owned": 47, "seg_tf_owned": 63}
OPS_PER_STEP["composite_f32"] = OPS_PER_STEP["composite"] + 8 * QUANTIZE_OPS_PER_TAP
OPS_PER_STEP["tf_f32"] = OPS_PER_STEP["tf"] + 8 * QUANTIZE_OPS_PER_TAP
# bytes per ray: the rays read (entry_uv, dir_step, hit) and B1's displayed
# image written (rgb and alpha)
RAY_BYTES, RGBA_BYTES = 25, 16
TRILINEAR_OPS, ISO_CLASSIFY_OPS = 41, 9
ISO_GATHERED_OPS = OPS_PER_STEP["iso"] + ISO_CLASSIFY_OPS
ISO_SKIPPED_OPS = OPS_PER_STEP["iso"] - TRILINEAR_OPS + ISO_CLASSIFY_OPS
SHADE_OPS_PER_HIT, SHADE_OPS_PER_STEP = 4 * 47 + 6 * 44 + 60, 3


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
    """Largest |kernel - plain| over color (or rgb) and alpha, and how many pixels
    exceed the tight bar; raises if the bars are missed."""
    d = None
    for k, p in zip(kernel_out, plain_out):
        dk = (k - p).abs()
        if dk.dim() == 3:  # an (H, W, 3) image: the largest channel of each pixel
            dk = dk.amax(dim=-1)
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float, samples: float, rays: int) -> dict:
    """The kernels line's bound of one launch moving ``n_bytes`` and doing
    ``ops`` float32 operations over ``samples`` samples; no single PyTorch
    call computes a ray march, so there is no library time."""
    b_ms, o_ms = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None, "bytes": n_bytes, "ops": ops, "samples_per_ray": samples / rays}


def tap_indices(pos: torch.Tensor, dims) -> torch.Tensor:
    """The flat (z, y, x) indices of the 8 clamp-mode taps of each position
    of ``pos`` (N, 3) on a volume of ``dims`` = (X, Y, Z)."""
    from volumerenderer_tpu_torch.ops.sampling import texel_coords

    X, Y, Z = dims
    i0, _ = texel_coords(pos, dims)

    def axis(k, n, stride):
        return [torch.clamp(i0[:, k] + j, 0, n - 1) * stride for j in (0, 1)]

    return torch.cat([z + y + x for z in axis(2, Z, X * Y) for y in axis(1, Y, X)
                      for x in axis(0, X, 1)])


def pool_tap_words(pos: torch.Tensor, dims, pool: torch.Tensor, slab_map: torch.Tensor):
    """The flat indices of the 4 slab-pool words (one per (z, y) row, both
    x taps in it) that the pooled sampler fetches for each position of
    ``pos`` (N, 3): ``ops/sampling.py::sample_trilinear_slab_pool``'s index
    math, for either pool format."""
    from volumerenderer_tpu_torch.ops.sampling import texel_coords

    X, Y, Z = dims
    i0, _ = texel_coords(pos, dims)
    words_per_row = pool.shape[-1]  # X // 2 (pair16) or X (narrow)
    xw = torch.clamp(i0[:, 0], 0, X - 1) // (X // words_per_row)
    ys = [torch.clamp(i0[:, 1] + j, 0, Y - 1) for j in (0, 1)]
    z0 = torch.clamp(i0[:, 2], 0, Z - 1)
    block = z0 >> 3
    slot = torch.clamp(slab_map.reshape(-1).to(torch.int64)[block], 0, pool.shape[0] - 1)
    rows = [(slot * 16 + torch.clamp(z0 + j, 0, Z - 1) - 8 * block) * Y for j in (0, 1)]
    return torch.cat([(r + y) * words_per_row + xw for r in rows for y in ys])


def composite_samples(plan, vol_plain, K: float = 0.6, touched: torch.Tensor | None = None,
                      pools: tuple = ()):
    """Per-ray samples of the compositing march with its a > 0.99 early-out
    (B1; B4 and B5 at alpha scale ``K``), counted by its plain arithmetic.
    With ``touched`` (a flat bool tensor of the volume's voxels) every voxel
    a sample's taps read is set in it; for each (mask, pool, slab_map) of
    ``pools`` every pool word the pooled march (B6, B7) fetches for those
    samples is set in the mask, a flat bool tensor of the pool's words."""
    from volumerenderer_tpu_torch.ops.sampling import sample_trilinear

    pos, alive = plan.entry_uv, plan.hit.bool()
    alpha = torch.zeros(plan.shape, device=pos.device)
    n = torch.zeros_like(alpha)
    for _ in range(plan.max_samples):
        if not bool(alive.any()):
            break
        pos = pos + plan.dir_step
        alive = alive & ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
        s = sample_trilinear(vol_plain, pos)
        alpha = torch.where(alive, alpha + (s - s * alpha) * K, alpha)
        n = n + alive
        if touched is not None:
            touched[tap_indices(pos[alive], plan.dims)] = True
        for mask, pool, slab_map in pools:
            mask[pool_tap_words(pos[alive], plan.dims, pool, slab_map)] = True
        alive = alive & (alpha <= 0.99)
    return n


def warp_steps(n: torch.Tensor, warp_hw) -> dict:
    """How the per-ray samples ``n`` (H, W) fill warps of ``warp_hw`` (rows,
    columns) pixels, as a warp runs until its slowest lane ends: the mean
    and the largest per-warp max and mean, and the lanes' share of the
    warps' steps (sum of means over sum of maxima)."""
    h, w = warp_hw
    H_, W_ = n.shape
    g = n.reshape(H_ // h, h, W_ // w, w).permute(0, 2, 1, 3).reshape(-1, h * w)
    mx, mean = g.amax(dim=1), g.mean(dim=1)
    return {"mean_of_warp_max": float(mx.mean()), "mean_of_warp_mean": float(mean.mean()),
            "max_of_warp_max": float(mx.max()),
            "lane_share": float(mean.sum() / mx.sum()) if float(mx.sum()) > 0 else None}


def march_steps(plan, boxes=None):
    """Per-ray steps inside the cube, up to max_samples; with ``boxes``
    ((N, 4) owned boxes z_lo, z_hi, y_lo, y_hi) the segment march's
    (walked, owned, entered) steps per box, (N, H, W) each: a walking march
    goes on until the ray leaves the cube or its owned interval ends; the
    entry table walks until the first owned step (``entered``, that step
    included)."""
    from volumerenderer_tpu_torch.ops.raycast import shard_owned

    pos, alive = plan.entry_uv, plan.hit.bool()
    n = torch.zeros(plan.shape, device=pos.device)
    if boxes is not None:
        b = torch.tensor(boxes, dtype=torch.float32, device=pos.device)[:, :, None, None]
        walking = alive.expand(len(boxes), *plan.shape).clone()
        was = torch.zeros_like(walking)
        walked = torch.zeros(walking.shape, device=pos.device)
        owned = torch.zeros_like(walked)
        entered = torch.zeros_like(walked)
    for _ in range(plan.max_samples):
        if not bool(alive.any()):
            break
        pos = pos + plan.dir_step
        alive = alive & ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
        n = n + alive
        if boxes is not None:
            own = shard_owned(pos, plan.dims, b.unbind(1))
            walking = walking & alive
            walked = walked + walking
            entered = entered + (walking & ~was)
            own = own & walking
            owned = owned + own
            walking = walking & ~(was & ~own)
            was = was | own
    return n if boxes is None else (walked, owned, entered)


def iso_samples(plan, found, t_hit, iso_bound=None) -> torch.Tensor:
    """Per-ray samples of the isosurface march: sample k (1-based) is taken
    at entry + k additions of dir_step, for k up to t_hit + 2 for a hit and
    the steps inside the cube + 1 for a miss.  With an IsoBound, only those
    whose block is mixed (the samples the bound march gathers)."""
    from volumerenderer_tpu_torch.ops.isosurface import classify_blocks

    last = torch.where(found, t_hit.float() + 2.0, march_steps(plan) + 1.0) * plan.hit
    pos = plan.entry_uv
    n = torch.zeros(plan.shape, device=pos.device)
    for k in range(1, int(last.max()) + 1):
        pos = pos + plan.dir_step
        take = last >= k
        if iso_bound is not None:
            below, above = classify_blocks(iso_bound, pos)
            take = take & ~below & ~above
        n = n + take
    return n


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


def device_profile(fn, top: int = 6) -> dict:
    """One call of ``fn`` (after a warm call) under torch.profiler: the
    device time of its ``top`` most costly kernels and copies by name, their
    total, the host wall time and the device's idle share of it (1 - device
    time / wall; the profiler's own host cost is inside the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, counts = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # host ops: their kernels are listed apart
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        counts[e.key[:60]] = counts.get(e.key[:60], 0) + e.count
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    device_ms = sum(by_name.values())
    worst = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ms": device_ms, "wall_ms": wall_ms,
            "idle_share": 1.0 - device_ms / wall_ms if wall_ms > 0 else None,
            "top_device_ms": {k[:60]: v for k, v in worst}, "device_events": counts}


def adversarial_volume(dev) -> torch.Tensor:
    """The 256^3 turbulence (seed 0) with, at seeded places, values below 0,
    above 1, and at (k + 0.5)/255 and one ulp either side: where a per-tap
    quantize could part from quantize_u8."""
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume

    rng = np.random.default_rng(8)
    v = turbulence_volume(VOLUME, seed=0).astype(np.float32) / np.float32(255)
    half = ((rng.integers(0, 255, VOLUME) + 0.5) / 255.0).astype(np.float32)
    pick = rng.integers(0, 8, VOLUME)
    for k, value in enumerate((-rng.random(VOLUME, dtype=np.float32),
                               np.float32(1) + rng.random(VOLUME, dtype=np.float32),
                               np.nextafter(half, np.float32(-1)), half,
                               np.nextafter(half, np.float32(2)))):
        v = np.where(pick == k, value, v)
    return torch.from_numpy(v.astype(np.float32)).to(dev)


def run_routes(dev, smi: str, turb, plans) -> None:
    """The fused B1 (float32 taps) against the byte route (a quantize pass,
    then B1 on the bytes, then the transfer) per frame over the orbit, on the
    turbulence and on it dimmed to 25 % and 2 %, whose rays run deeper: the
    float32 volume (67 MB) does not fit the 50 MB L2, the byte one does."""
    from volumerenderer_tpu_torch import as_normalized_volume
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK

    quantize_bound_ms = 1e3 * 5 * turb.numel() / HBM_BYTES_PER_S  # read f32, write u8
    for name, vol in (("turbulence", turb), ("dim25", turb * 0.25), ("dim2", turb * 0.02)):
        u8 = RK.quantize_u8(vol)

        def byte_frame(p):
            c, a = RK.composite_march_cuda(RK.quantize_u8(vol), p.entry_uv, p.dir_step, p.hit)
            return RK.apply_reference_transfer(c, a), a

        ms = {"fused_frame": time_ms(lambda: [p.render(vol) for p in plans]) / N_FRAMES,
              "byte_route_frame": time_ms(lambda: [byte_frame(p) for p in plans]) / N_FRAMES,
              "byte_route_march": time_ms(lambda: [RK.composite_march_cuda(
                  u8, p.entry_uv, p.dir_step, p.hit) for p in plans]) / N_FRAMES,
              "quantize_u8": time_ms(lambda: RK.quantize_u8(vol))}
        ms["byte_march_plus_quantize_at_bound"] = ms["byte_route_march"] + quantize_bound_ms
        mask = torch.zeros(vol.numel(), dtype=torch.bool, device=dev)
        n = composite_samples(plans[0], as_normalized_volume(u8), touched=mask)
        emit({"phase": "b1_routes", "volume": name, "ms_per_frame": ms,
              "fused_faster_than_byte_route_at_bound": ms["fused_frame"] <
              ms["byte_march_plus_quantize_at_bound"],
              "frame0_samples_per_ray": float(n.mean()),
              "frame0_touched_voxels": int(mask.sum()), "gpu": smi})


def run_isosurface(dev, smi: str, turb, sphere, cameras, bundles) -> list:
    """The isosurface phases; returns the kernels line's two entries."""
    from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
    from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import quantize_u8
    from volumerenderer_tpu_torch.ops.isosurface import (iso_march_steps, render_isosurface,
                                                         shade_hits)

    # the isosurface golden of tests/test_goldens.py, through both kernels
    vol = as_normalized_volume(turbulence_volume((32, 32, 32), seed=99), device=dev)
    rays = generate_rays(Camera(width=64, height=48), device=dev)
    gplan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (32, 32, 32))
    golden = {}
    for name, ib in (("unbound", None), ("bound", gplan.bind(vol))):
        rgb, found = gplan.render(vol, bound=ib)
        total, hits = float(rgb.sum()), int(found.sum())
        if abs(total - ISO_GOLDEN_RGB) >= ISO_GOLDEN_TOL or hits != ISO_GOLDEN_HITS:
            raise AssertionError(f"iso golden through the kernels ({name}): sum {total}, {hits} "
                                 f"hits; expected {ISO_GOLDEN_RGB} within {ISO_GOLDEN_TOL}, "
                                 f"{ISO_GOLDEN_HITS} hits")
        golden[name] = {"sum_rgb": total, "hits": hits}
    emit({"phase": "iso_goldens", **golden["unbound"], "bound": golden["bound"],
          "tol": ISO_GOLDEN_TOL})

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
        # bound: the kernel and the plain march from the volume's grid, the
        # kernel from its mip8's, each bit-equal to its unbound version
        bounds = {"volume": plan.bind(v, iso), "mip8": plan.bind(v, iso,
                                                                 mip8=RK.block_max8(vol_u8))}
        bound_equal = {}
        for bname, ib in bounds.items():
            fb, tb = IK.iso_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit, iso,
                                       plan.max_samples, wrap, ib)
            bound_equal[f"kernel_{bname}"] = bool(torch.equal(fb, found_k)
                                                  and torch.equal(tb, t_hit_k))
        fb, tb = iso_march_steps(plain_vol, plan.entry_uv, plan.dir_step, plan.hit.bool(), iso,
                                 plan.max_samples, wrap, bounds["volume"])
        bound_equal["plain_volume"] = bool(torch.equal(fb, found_p) and torch.equal(tb, t_hit_p))
        torch.cuda.synchronize()
        if not all(bound_equal.values()):
            raise AssertionError(f"iso {name}: a bound march differs from its unbound one: "
                                 f"{bound_equal}")
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
              "rgb_px_beyond_1e-6": int(((rgb_k - rgb_p).abs() > 1e-6).sum()),
              "bound_bit_equal": bound_equal})

    # the main path: the 16-frame orbit at the volume's median, plans built
    # once per camera and one bound for the volume and isovalue, which every
    # plan shares (bench.py:86 times bound plans); min of REPS sweeps after a
    # warm sweep: bound with the bind outside the sweep (a reused volume and
    # isovalue), with the bind inside it (a new pair each orbit), and
    # unbound; and one frame that pays its own bind (a new pair each frame).
    # The launch counts cover exactly this run.
    plans = [IK.IsosurfacePlan(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]
    iso_bound = plans[0].bind(turb, iso_med)
    IK.iso_march_cuda.launches = 0
    IK.iso_shade_cuda.launches = 0
    renders = 0
    last = {}

    def kernel_sweep(mode: str):
        nonlocal renders
        acc = torch.zeros((), device=dev)
        b = {"unbound": None, "bound": iso_bound,
             "bind_in_sweep": plans[0].bind(turb, iso_med) if mode == "bind_in_sweep" else None}
        for plan in plans:
            last["rgb"], last["found"] = plan.render(turb, iso_med, bound=b[mode])
            acc = acc + last["rgb"].sum()
            renders += 1
        return float(acc)

    def frame_with_own_bind():
        nonlocal renders
        rgb, _ = plans[0].render(turb, iso_med, bound=plans[0].bind(turb, iso_med))
        renders += 1
        return float(rgb.sum())

    def plain_sweep():
        acc = torch.zeros((), device=dev)
        for r in bundles:
            rgb, _ = render_isosurface(turb, r.entry_uv, r.direction, r.hit, iso_med)
            acc = acc + rgb.sum()
        return float(acc)

    unbound_sweep_s = sweep_seconds(lambda: kernel_sweep("unbound"))
    rgb_unbound = last["rgb"]
    bind_sweep_s = sweep_seconds(lambda: kernel_sweep("bind_in_sweep"))
    own_bind_s = sweep_seconds(frame_with_own_bind)
    kernel_sweep_s = sweep_seconds(lambda: kernel_sweep("bound"))
    launches = {"iso_march": IK.iso_march_cuda.launches, "iso_shade": IK.iso_shade_cuda.launches}
    plain_sweep_s = sweep_seconds(plain_sweep)
    rgb, found = last["rgb"], last["found"]
    if not torch.equal(rgb, rgb_unbound):
        raise AssertionError("iso main path: the bound frame differs from the unbound one")
    if rgb.shape != (H, W, 3) or found.shape != (H, W) or not bool(torch.isfinite(rgb).all()) \
            or not bool(((rgb >= 0) & (rgb <= 1)).all()) or not 0 < int(found.sum()) < H * W:
        raise AssertionError(f"iso main path output: rgb {tuple(rgb.shape)}, found "
                             f"{tuple(found.shape)} with {int(found.sum())} hits; "
                             f"finite/in-range/hit check failed")
    emit({"phase": "iso_main_path", "metric": "iso_rays_per_s_per_chip_1024sq_256cube",
          "iso": iso_med, "kernel_rays_per_s": W * H / (kernel_sweep_s / N_FRAMES),
          "unbound_rays_per_s": W * H / (unbound_sweep_s / N_FRAMES),
          "plain_rays_per_s": W * H / (plain_sweep_s / N_FRAMES),
          "kernel_ms_per_frame": 1e3 * kernel_sweep_s / N_FRAMES,
          "bind_in_sweep_ms_per_frame": 1e3 * bind_sweep_s / N_FRAMES,
          "frame_with_own_bind_ms": 1e3 * own_bind_s,
          "unbound_ms_per_frame": 1e3 * unbound_sweep_s / N_FRAMES,
          "plain_ms_per_frame": 1e3 * plain_sweep_s / N_FRAMES,
          "bind_ms": time_ms(lambda: plans[0].bind(turb, iso_med)), "bound_frame_equal": True,
          "hits_last_frame": int(found.sum()), "frames": N_FRAMES, "reps": REPS, "gpu": smi})

    # per-launch times of each kernel and its plain version over the orbit,
    # then frame 0 split into its layers
    turb_u8 = quantize_u8(turb)
    turb_plain = as_normalized_volume(turb_u8)
    hits = [IK.iso_march_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit, iso_med) for p in plans]

    def march_ms(b):
        return time_ms(lambda: [IK.iso_march_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit,
                                                  iso_med, bound=b)
                                for p in plans]) / N_FRAMES

    ms = {"iso_march": march_ms(iso_bound), "iso_march_unbound": march_ms(None),
          "iso_shade": time_ms(lambda: [IK.iso_shade_cuda(turb_u8, p.entry_uv, p.dir_step,
                                                          p.direction, f, t, iso_med)
                                        for p, (f, t) in zip(plans, hits)]) / N_FRAMES}
    # the plain marches on frames 0 and 15 (~0.25 s a frame)
    ends = (0, N_FRAMES - 1)
    plain_ms = {
        name: sum(time_ms(lambda: iso_march_steps(turb_plain, plans[i].entry_uv,
                                                  plans[i].dir_step, plans[i].hit.bool(),
                                                  iso_med, bound=b), reps=1)
                  for i in ends) / len(ends)
        for name, b in (("iso_march", iso_bound), ("iso_march_unbound", None))}
    plain_ms["iso_shade"] = time_ms(lambda: [shade_hits(turb_plain, p.entry_uv, p.dir_step,
                                                        p.direction, f, t, iso_med)
                                             for p, (f, t) in zip(plans, hits)]) / N_FRAMES
    # samples per ray the unbound march takes, and those the bound one gathers
    per_ray = {name: sum(float(iso_samples(p, f, t, b).sum())
                         for p, (f, t) in zip(plans, hits)) / (N_FRAMES * W * H)
               for name, b in (("samples", None), ("gathered", iso_bound))}
    emit({"phase": "iso_timing", "shape": [H, W], "volume": list(VOLUME), "iso": iso_med,
          "frames": N_FRAMES, "plain_frames": list(ends), "kernel_ms_per_launch": ms,
          "plain_ms_per_launch": plain_ms, "per_ray": per_ray, "gpu": smi})
    rays0, plan0, (f0, t0) = bundles[0], plans[0], hits[0]
    emit({"phase": "iso_layers", "ms": {
        "volume_median": time_ms(lambda: IK.volume_median(turb)),
        "plan": time_ms(lambda: IK.IsosurfacePlan(rays0.entry_uv, rays0.direction, rays0.hit,
                                                  VOLUME[::-1])),
        "quantize_u8": time_ms(lambda: quantize_u8(turb)),
        "bind": time_ms(lambda: plan0.bind(turb, iso_med)),
        "march_kernel": time_ms(lambda: IK.iso_march_cuda(turb_u8, plan0.entry_uv,
                                                          plan0.dir_step, plan0.hit, iso_med,
                                                          bound=iso_bound)),
        "march_kernel_unbound": time_ms(lambda: IK.iso_march_cuda(
            turb_u8, plan0.entry_uv, plan0.dir_step, plan0.hit, iso_med)),
        "shade_kernel": time_ms(lambda: IK.iso_shade_cuda(turb_u8, plan0.entry_uv,
                                                          plan0.dir_step, plan0.direction,
                                                          f0, t0, iso_med))},
        "hits_frame0": int(f0.sum()), "gpu": smi})

    # the main path went through both kernels, once per render each
    if renders == 0 or any(n != renders for n in launches.values()):
        raise AssertionError(f"isosurface kernels launched {launches} times for {renders} "
                             f"renders")
    emit({"phase": "iso_launch_count", **launches, "renders": renders})

    # the bounds, per launch over the orbit: a hit samples at steps 0..t_hit
    # and once before, a miss once per step inside the cube and once before
    samples, shade_ops = 0.0, 0.0
    io = {"iso_march": 0, "iso_shade": 0}
    for p, (f, t) in zip(plans, hits):
        found = f.bool()
        steps = torch.where(found, t.float() + 2.0, march_steps(p) + 1.0) * p.hit
        samples += float(steps.sum())
        shade_ops += float((SHADE_OPS_PER_STEP * (t.float() + 2.0) + SHADE_OPS_PER_HIT)[found].sum())
        io["iso_march"] += nbytes(turb_u8, p.entry_uv, p.dir_step, p.hit, f, t)
        io["iso_shade"] += nbytes(turb_u8, p.entry_uv, p.dir_step, p.direction, f, t) + 12 * W * H
    # the march's bound is the bound march's (the main path's launch): its
    # gathered and skipped samples and the grid's bytes; the formula of the
    # march without the skip beside it, with the unbound launch's time
    gathered = per_ray["gathered"] * W * H
    skipped = samples / N_FRAMES - gathered
    unskipped = bound(io["iso_march"] / N_FRAMES, OPS_PER_STEP["iso"] * samples / N_FRAMES,
                      samples / N_FRAMES, W * H)
    roof = {"iso_march": bound(io["iso_march"] / N_FRAMES + nbytes(iso_bound.grid),
                               ISO_GATHERED_OPS * gathered + ISO_SKIPPED_OPS * skipped,
                               samples / N_FRAMES, W * H),
            "iso_shade": bound(io["iso_shade"] / N_FRAMES, shade_ops / N_FRAMES,
                               10.0 * sum(float(f.sum()) for f, _ in hits) / N_FRAMES, W * H)}
    extra = {"iso_march": {"gathered_per_ray": per_ray["gathered"],
                           "bound_ms_unskipped_formula": unskipped["bound_ms"],
                           "ops_unskipped_formula": unskipped["ops"],
                           "ms_unbound": ms["iso_march_unbound"],
                           "plain_ms_unbound": plain_ms["iso_march_unbound"]},
             "iso_shade": {}}
    return [{"name": name, "route": "cuda", "source": ISO_SOURCES[name],
             "replaces": ISO_REPLACES[name], "launches": launches[name],
             "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
             **roof[name], **extra[name]}
            for name in ("iso_march", "iso_shade")]


def run_gradients(dev, smi: str, turb, sphere, cameras, bundles, samples: float,
                  touched: float, adversarial) -> list:
    """The gradient phases; returns the kernels line's two entries.
    ``samples`` and ``touched`` (the voxels the taps read) are B1's per
    launch over the orbit: at reference params B4 and B5 take the same
    steps.  ``adversarial`` is the main phase's volume made to part a
    per-tap quantize from quantize_u8."""
    from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.diff import closed_form as CF
    from volumerenderer_tpu_torch.diff.vjp import render_tf_o1
    from volumerenderer_tpu_torch.models import plan_compositing
    from volumerenderer_tpu_torch.ops.cuda import _launch
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.cuda import tf_kernel as TK
    from volumerenderer_tpu_torch.ops.cuda import voxel_grad_kernel as VK

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    reference = TFParams.reference(dev)
    # the non-reference params of tests/test_pallas_interpret.py:300-304
    param_sets = {"reference": reference,
                  "non_reference": TFParams(f32(0.45), f32(0.9), f32(0.05),
                                            f32([-0.8, 0.6, 0.3]), f32([0.9, 0.2, 0.4]))}
    cases = [("entry_sphere", sphere, Camera(width=W, height=H)),
             ("orbit_frame0", turb, cameras[0]), ("orbit_frame15", turb, cameras[-1]),
             ("adversarial_frame0", adversarial, cameras[0])]

    # B4 vs its plain version: all seven images; the fused B4 (float32
    # taps quantized as read) bit for bit B4 on quantize_u8 of the volume;
    # at reference params color and alpha also equal B1's
    err = {"tf_march": 0.0, "voxel_grad": 0.0}
    vg_inputs = []
    for name, v, cam in cases:
        rays = generate_rays(cam, device=dev)
        Z, Y, X = v.shape
        plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
        vol_u8 = RK.quantize_u8(v)
        plain_vol = as_normalized_volume(vol_u8)
        for pname, params in param_sets.items():
            tf = CF.tf_scalars(params)
            k = TK.tf_march_f32_cuda(v, plan.entry_uv, plan.dir_step, plan.hit, tf)
            kb = TK.tf_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit, tf)
            p = CF.tf_march_steps(plain_vol, plan.entry_uv, plan.dir_step, plan.hit.bool(), tf)
            torch.cuda.synchronize()
            bit_equal = {"fused_vs_byte_route": all(torch.equal(a, b) for a, b in zip(k, kb)),
                         "fused_vs_plain": all(torch.equal(a, b) for a, b in zip(k, p))}
            if not bit_equal["fused_vs_byte_route"]:
                raise AssertionError(f"tf {name} {pname}: the fused B4 differs from B4 on "
                                     f"quantize_u8 of the volume")
            res = compare(k[:2], p[:2], cam.width * cam.height)
            rel = torch.stack([(a - b).abs() / torch.clamp(b.abs(), min=1.0)
                               for a, b in zip(k[2:], p[2:])]).amax(dim=0)
            sums_over = int((rel > TF_SUMS_REL).sum())
            if sums_over > res["px_allowed"]:
                raise AssertionError(f"tf {name} {pname}: {sums_over} px of the five sums beyond "
                                     f"{TF_SUMS_REL} relative (allowed {res['px_allowed']:g})")
            max_abs = max(float((a - b).abs().max()) for a, b in zip(k, p))
            err["tf_march"] = max(err["tf_march"], max_abs)
            line = {"phase": "tf_parity", "case": name, "params": pname,
                    "hw": [cam.height, cam.width], **res, "max_abs_err_7": max_abs,
                    "sums_max_rel_err": float(rel.max()), "sums_px_beyond": sums_over,
                    "alpha_sum_kernel": float(k[1].sum()), "R_sum_kernel": float(k[2].sum()),
                    "bit_equal": bit_equal,
                    "px_differ_plain": int(sum((a != b) for a, b in zip(k, p)).gt(0).sum())}
            if pname == "reference":
                c1, a1 = RK.composite_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit)
                line["color_alpha_equal_b1"] = bool(torch.equal(c1, k[0]) and torch.equal(a1, k[1]))
                if not line["color_alpha_equal_b1"]:
                    raise AssertionError(f"tf {name}: at reference params B4's color/alpha "
                                         f"differ from B1's")
            emit(line)
            if not name.startswith("adversarial"):  # B5 is held on the earlier cases
                vg_inputs.append((name, pname, params, plan, vol_u8, plain_vol, k))

    # B5 vs its plain version on the same cases, seeded cotangents, fed B4's
    # alpha_T and P_total; and the conservation check: the 8 trilinear
    # weights sum to 1, so sum(g_vol) = sum of every alive step's g_s
    for i, (name, pname, params, plan, vol_u8, plain_vol, k) in enumerate(vg_inputs):
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        g_rgb = torch.randn((H, W, 3), generator=gen, device=dev)
        g_alpha = torch.randn((H, W), generator=gen, device=dev)
        tf = CF.tf_scalars(params)
        gc, gaT_term = CF.cotangent_images(params, g_rgb, g_alpha, k[1])
        args = (plan.entry_uv, plan.dir_step)
        g_k = VK.voxel_grad_cuda(vol_u8, *args, plan.hit, tf, gc, gaT_term, k[3])
        g_p = CF.voxel_grad_steps(plain_vol, *args, plan.hit.bool(), tf, gc, gaT_term, k[3])
        gs_sum = gs_abs = 0.0
        for _, g_s in CF.step_cotangents(plain_vol, *args, plan.hit.bool(), tf, gc, gaT_term,
                                         k[3]):
            gs_sum += float(g_s.double().sum())
            gs_abs += float(g_s.double().abs().sum())
        torch.cuda.synchronize()
        scale = float(g_p.abs().max())
        max_abs = float((g_k - g_p).abs().max())
        rel = max_abs / scale
        conservation = abs(float(g_k.double().sum()) - gs_sum) / gs_abs
        if not rel <= VG_REL or not conservation <= VG_CONSERVATION:
            raise AssertionError(f"voxel_grad {name} {pname}: max |d| / max |g| {rel} (bar "
                                 f"{VG_REL}), conservation {conservation} (bar "
                                 f"{VG_CONSERVATION})")
        err["voxel_grad"] = max(err["voxel_grad"], max_abs)
        emit({"phase": "vg_parity", "case": name, "params": pname, "max_abs_err": max_abs,
              "max_abs_g_plain": scale, "rel_err": rel, "bar": VG_REL,
              "sum_g_vol_kernel": float(g_k.double().sum()), "sum_alive_g_s": gs_sum,
              "sum_abs_alive_g_s": gs_abs, "conservation_rel": conservation})
    del vg_inputs

    # the whole kernel path on a small input vs the plain O(1) reverse march,
    # on tests/test_pallas_interpret.py's scene: a random 8-bit (8, 16, 128)
    # volume, 64x32 rays, 24 steps (short of the 0.99 early-out, where the
    # reverse march's analytic positions could move a ray's last step)
    rng = np.random.default_rng(7)
    vol_s = as_normalized_volume(np.round(rng.random((8, 16, 128)) * 255.0).astype(np.uint8),
                                 device=dev)
    rays_s = generate_rays(Camera(width=64, height=32), device=dev)
    plan_s = plan_compositing(rays_s.entry_uv, rays_s.direction, rays_s.hit, (128, 16, 8), 24)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    w_rgb = torch.randn((32, 64, 3), generator=gen, device=dev)
    w_a = torch.randn((32, 64), generator=gen, device=dev)
    grads = []
    for f in (VK.make_render_tf_voxel(plan_s),
              lambda p, v: render_tf_o1(p, v, rays_s.entry_uv, rays_s.direction, rays_s.hit,
                                        24)):
        leaves = TFParams(*(t.clone().requires_grad_(True) for t in param_sets["non_reference"]))
        vt = vol_s.clone().requires_grad_(True)
        rgb, a = f(leaves, vt)
        grads.append(torch.autograd.grad(torch.sum(rgb * w_rgb) + torch.sum(a * w_a),
                                         [*leaves, vt]))
    (*gp_k, gv_k), (*gp_r, gv_r) = grads
    gv_scale = max(1.0, float(gv_r.abs().max()))
    gv_err = float((gv_k - gv_r).abs().max())
    gp_err = {n: float(((k - r).abs() / (r.abs() + max(1.0, float(r.abs().max())))).max())
              for n, k, r in zip(TFParams._fields, gp_k, gp_r)}
    if gv_err > 2e-4 * gv_scale or max(gp_err.values()) > 2e-4:
        raise AssertionError(f"kernel path vs render_tf_o1: g_vol max |d| {gv_err} (bar "
                             f"{2e-4 * gv_scale}), params {gp_err} (bar 2e-4)")
    emit({"phase": "grad_reference", "hw": [32, 64], "volume": [8, 16, 128], "max_samples": 24,
          "g_vol_max_abs_err": gv_err, "g_vol_bar": 2e-4 * gv_scale,
          "param_rel_err": gp_err, "param_bar": 2e-4})

    # the main path on orbit frame 0: the config-4 TF fit, then the voxel
    # grad step against one forward frame (bench.py's protocol).  The launch
    # counts cover exactly this run: every forward is one launch of the
    # fused B4 and none of its byte route.
    TK.tf_march_f32_cuda.launches = 0
    TK.tf_march_cuda.launches = 0
    VK.voxel_grad_cuda.launches = 0
    forwards = backwards = 0
    rays0 = bundles[0]
    plan0 = plan_compositing(rays0.entry_uv, rays0.direction, rays0.hit, VOLUME[::-1])
    target = torch.full((H, W, 3), 0.5, device=dev)
    f_tf = TK.make_render_tf_kernel(plan0)
    params = reference
    losses, fit_step_ms = [], []
    for _ in range(FIT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = TK.tf_fit_step_fast(f_tf, params, turb, target, lr=FIT_LR)
        torch.cuda.synchronize()
        fit_step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        forwards += 1
    losses = [float(x) for x in losses]
    fit_params = {n: t.tolist() for n, t in zip(TFParams._fields, params)}

    f_vox = VK.make_render_tf_voxel(plan0)
    last = {}

    def grad_step():
        nonlocal forwards, backwards
        leaves = TFParams(*(t.clone().requires_grad_(True) for t in reference))
        vol = turb.detach().requires_grad_(True)
        rgb, _ = f_vox(leaves, vol)
        loss = torch.mean((rgb - target) ** 2)
        *gp, gv = torch.autograd.grad(loss, [*leaves, vol])
        forwards += 1
        backwards += 1
        last["gp"], last["gv"], last["loss"] = gp, gv, loss
        return float(gp[0] + gv.sum())

    def fwd_frame():
        rgb, _ = plan0.render(turb)
        return float(rgb.sum())

    frame_s = sweep_seconds(fwd_frame)
    step_s = sweep_seconds(grad_step)
    launches = {"tf_march": TK.tf_march_f32_cuda.launches,
                "voxel_grad": VK.voxel_grad_cuda.launches}
    tf_byte_launches = TK.tf_march_cuda.launches
    runs = {"forwards": forwards, "backwards": backwards}
    gp, gv = last["gp"], last["gv"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"TF fit losses {losses}: not finite or not lowered")
    if gv.shape != turb.shape or not bool(torch.isfinite(gv).all()) or not bool(gv.any()) \
            or not all(bool(torch.isfinite(g).all()) for g in gp):
        raise AssertionError(f"voxel grad step: g_vol {tuple(gv.shape)}, finite/nonzero check "
                             f"failed, or a non-finite param gradient")

    def plain_grad_step():
        """The same step with each kernel's plain version on the card."""
        vol_u8 = RK.quantize_u8(turb)
        plain_vol = as_normalized_volume(vol_u8)
        tf = CF.tf_scalars(reference)
        partials = CF.tf_march_steps(plain_vol, plan0.entry_uv, plan0.dir_step,
                                     plan0.hit.bool(), tf)
        rgb = (reference.flip_sign * partials[0][..., None]
               + reference.flip_bias).requires_grad_(True)
        (g_rgb,) = torch.autograd.grad(torch.mean((rgb - target) ** 2), [rgb])
        gc, gaT_term = CF.cotangent_images(reference, g_rgb, None, partials[1])
        g_params = CF.tf_param_grads(reference, partials, g_rgb, gc, gaT_term)
        g_vol = CF.voxel_grad_steps(plain_vol, plan0.entry_uv, plan0.dir_step, plan0.hit.bool(),
                                    tf, gc, gaT_term, partials[3])
        return float(g_params.alpha_scale + g_vol.sum())

    plain_step_s = sweep_seconds(plain_grad_step)
    emit({"phase": "grad_main_path", "metric": "voxelgrad_step_frames_1024sq_256cube",
          "value": step_s / frame_s, "unit": "forward-frames/step",
          "step_ms": 1e3 * step_s, "frame_ms": 1e3 * frame_s,
          "plain_step_ms": 1e3 * plain_step_s, "plain_step_frames": plain_step_s / frame_s,
          "loss": float(last["loss"].detach()), "g_alpha_scale": float(gp[0]),
          "g_vol_abs_max": float(gv.abs().max()), "fit_losses": losses, "fit_lr": FIT_LR,
          "fit_step_ms": fit_step_ms, "fit_params": fit_params, "reps": REPS, "gpu": smi})

    # per-launch times of both kernels and their plain versions over the
    # orbit, fed the main path's cotangents (MSE against 0.5 at reference
    # params); the voxel_grad wrapper's time includes its zero fill
    plans = [plan_compositing(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]
    turb_u8 = RK.quantize_u8(turb)
    turb_plain = as_normalized_volume(turb_u8)
    tf = CF.tf_scalars(reference)
    cots = []
    for plan in plans:
        k = TK.tf_march_cuda(turb_u8, plan.entry_uv, plan.dir_step, plan.hit, tf)
        rgb = reference.flip_sign * k[0][..., None] + reference.flip_bias
        g_rgb = (rgb - target) * (2.0 / rgb.numel())
        cots.append((*CF.cotangent_images(reference, g_rgb, None, k[1]), k[3]))
    ms = {
        "tf_march": time_ms(lambda: [TK.tf_march_f32_cuda(turb, p.entry_uv, p.dir_step, p.hit, tf)
                                     for p in plans]) / N_FRAMES,
        "tf_march_byte_route": time_ms(lambda: [
            TK.tf_march_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit, tf)
            for p in plans]) / N_FRAMES,
        "voxel_grad": time_ms(lambda: [VK.voxel_grad_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit,
                                                          tf, *c)
                                       for p, c in zip(plans, cots)]) / N_FRAMES}
    plain_ms = {
        "tf_march": time_ms(lambda: [CF.tf_march_steps(turb_plain, p.entry_uv, p.dir_step,
                                                       p.hit.bool(), tf)
                                     for p in plans]) / N_FRAMES,
        "voxel_grad": time_ms(lambda: [CF.voxel_grad_steps(turb_plain, p.entry_uv, p.dir_step,
                                                           p.hit.bool(), tf, *c)
                                       for p, c in zip(plans, cots)]) / N_FRAMES}
    emit({"phase": "grad_timing", "shape": [H, W], "volume": list(VOLUME), "frames": N_FRAMES,
          "params": "reference", "kernel_ms_per_launch": ms, "plain_ms_per_launch": plain_ms,
          "voxel_grad_includes_zero_fill": True, "gpu": smi})

    # one voxel-grad step of orbit frame 0 split into its layers; the B5
    # kernel alone runs into a buffer filled once, outside the timing
    k0 = TK.tf_march_cuda(turb_u8, plan0.entry_uv, plan0.dir_step, plan0.hit, tf)
    rgb0 = (reference.flip_sign * k0[0][..., None] + reference.flip_bias).requires_grad_(True)
    (g_rgb0,) = torch.autograd.grad(torch.mean((rgb0 - target) ** 2), [rgb0])
    gc0, gaT0 = CF.cotangent_images(reference, g_rgb0, None, k0[1])
    g_buf = torch.zeros(turb.shape, dtype=torch.float32, device=dev)
    Z, Y, X = turb.shape

    def b5_alone():
        _launch.launch(VK._launcher, "voxel_grad", dev, plan0.entry_uv.data_ptr(),
                       plan0.dir_step.data_ptr(), plan0.hit.data_ptr(), turb_u8.data_ptr(),
                       tf.data_ptr(), gc0.data_ptr(), gaT0.data_ptr(), k0[3].data_ptr(),
                       H, W, X, Y, Z, plan0.max_samples, g_buf.data_ptr(), None)

    def loss_and_cotangent():
        rgb = (reference.flip_sign * k0[0][..., None] + reference.flip_bias).requires_grad_(True)
        return torch.autograd.grad(torch.mean((rgb - target) ** 2), [rgb])

    def sgd_update():
        return ([p - FIT_LR * g for p, g in zip(reference, gp)], turb - FIT_LR * gv)

    layers = {
        "quantize_u8": time_ms(lambda: RK.quantize_u8(turb)),
        "tf_march_kernel": time_ms(lambda: TK.tf_march_f32_cuda(turb, plan0.entry_uv,
                                                                plan0.dir_step, plan0.hit, tf)),
        "tf_march_kernel_byte_route": time_ms(lambda: TK.tf_march_cuda(
            turb_u8, plan0.entry_uv, plan0.dir_step, plan0.hit, tf)),
        "transfer_loss_and_cotangent": time_ms(loss_and_cotangent),
        "cotangent_images": time_ms(lambda: CF.cotangent_images(reference, g_rgb0, None, k0[1])),
        "param_grad_reductions": time_ms(lambda: CF.tf_param_grads(reference, k0, g_rgb0, gc0,
                                                                   gaT0)),
        "zero_fill": time_ms(lambda: torch.zeros(turb.shape, dtype=torch.float32, device=dev)),
        "voxel_grad_kernel": time_ms(b5_alone),
        "sgd_update": time_ms(sgd_update),
        "whole_step_events": time_ms(grad_step)}
    tf_fit_step_ms = time_ms(lambda: TK.tf_fit_step_fast(f_tf, reference, turb, target,
                                                         lr=FIT_LR))
    emit({"phase": "grad_layers", "ms": layers,
          "sum_of_layers": sum(v for n, v in layers.items()
                               if n not in ("whole_step_events", "tf_march_kernel_byte_route")),
          "tf_fit_step_events_ms": tf_fit_step_ms, "gpu": smi})

    # B5's blocks: how many accumulated in their shared tile and how many
    # added to device memory, the launch's global atomicAdds (and the 8 per
    # alive step a launch without the tile would make) and the blocks'
    # boxes, on orbit frames 0 and 15 (the main path's cotangents), and on
    # frame 0 of a volume dimmed to 25 % and to 2 %, whose deeper rays
    # overflow the tile
    for name, vol_u8, plan, c in (("orbit_frame0", turb_u8, plans[0], cots[0]),
                                  ("orbit_frame15", turb_u8, plans[-1], cots[-1]),
                                  ("dim25_frame0", RK.quantize_u8(turb * 0.25), plans[0], None),
                                  ("dim2_frame0", RK.quantize_u8(turb * 0.02), plans[0], None)):
        if c is None:  # the dimmed volume's own forward and cotangents
            kd = TK.tf_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit, tf)
            rgb_d = reference.flip_sign * kd[0][..., None] + reference.flip_bias
            c = (*CF.cotangent_images(reference, (rgb_d - target) * (2.0 / rgb_d.numel()), None,
                                      kd[1]), kd[3])
        args = (vol_u8, plan.entry_uv, plan.dir_step, plan.hit, tf, *c)
        g_k, stats = VK.voxel_grad_block_stats(*args)
        # the kernel alone (no zero fill)
        tensors = dict(zip(("vol_u8", "entry_uv", "dir_step", "hit", "tf_scalars", "gc",
                            "gaT_term", "P_tot"), args))
        ms_case = time_ms(lambda: VK._launch_vg(tensors, plan.max_samples, g_buf, None))
        g_p = CF.voxel_grad_steps(as_normalized_volume(vol_u8), plan.entry_uv, plan.dir_step,
                                  plan.hit.bool(), tf, *c)
        torch.cuda.synchronize()
        rel = float((g_k - g_p).abs().max()) / float(g_p.abs().max())
        if not rel <= VG_REL:
            raise AssertionError(f"voxel_grad {name} with its block counters: max |d| / max |g| "
                                 f"{rel} (bar {VG_REL})")
        emit({"phase": "vg_tile", "case": name, **stats, "kernel_ms": ms_case, "rel_err": rel,
              "gpu": smi})

    # the main path went through both kernels: B4 once per forward, B5 once
    # per backward
    if launches["tf_march"] != runs["forwards"] or launches["voxel_grad"] != runs["backwards"] \
            or not runs["forwards"] or not runs["backwards"] or tf_byte_launches:
        raise AssertionError(f"gradient kernels launched {launches} times for {runs}, B4's "
                             f"byte route {tf_byte_launches} times")
    emit({"phase": "grad_launch_count", **launches, **runs,
          "tf_march_byte_route": tf_byte_launches})
    # B4's bound as B1's: the float32 voxels its taps read (B1's at
    # reference params), the rays, the TF scalars and the seven planes
    rays_io = sum(nbytes(p.entry_uv, p.dir_step, p.hit) for p in plans) / N_FRAMES
    tf_io = nbytes(tf) + rays_io + 7 * 4 * W * H
    tf_ops = OPS_PER_STEP["tf_f32"] * samples
    bounds = {"tf_march": {**bound(4 * touched + tf_io, tf_ops, samples, W * H),
                           "volume_route": "float32, each tap quantized as read",
                           "bound_ms_whole_volume": bound(nbytes(turb) + tf_io, tf_ops, samples,
                                                          W * H)["bound_ms"],
                           "byte_route_ms": ms["tf_march_byte_route"],
                           "byte_route_bound_ms": bound(touched + tf_io,
                                                        OPS_PER_STEP["tf"] * samples, samples,
                                                        W * H)["bound_ms"]},
              "voxel_grad": bound(nbytes(turb_u8, tf, *cots[0]) + rays_io + 4 * turb.numel(),
                                  OPS_PER_STEP["voxel_grad"] * samples, samples, W * H)}
    return [{"name": name, "route": "cuda", "source": GRAD_SOURCES[name],
             "replaces": GRAD_REPLACES[name], "launches": launches[name],
             "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
             **bounds[name]}
            for name in ("tf_march", "voxel_grad")]


def run_compressed(dev, smi: str, turb, sphere, cameras, bundles, dense: dict,
                   samples: float) -> list:
    """The compressed-domain phases; returns the kernels line's five entries.
    ``dense`` holds the kernels line's entries of B1, B2 and B3: each pooled
    kernel's output, and so its samples, are its dense kernel's; ``samples``
    is B1's per launch over the orbit."""
    from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.codecs import device as CD
    from volumerenderer_tpu_torch.codecs import kdtree as KT
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
    from volumerenderer_tpu_torch.models import CompressedRenderer
    from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.isosurface import iso_march_steps, shade_hits
    from volumerenderer_tpu_torch.ops.raycast import apply_reference_transfer, composite_march_steps
    from volumerenderer_tpu_torch.ops.sampling import slab_pool_sampler

    # 1. the tree, built on the host from the 256^3 turbulence
    source = turbulence_volume(VOLUME, seed=0)
    t0 = time.perf_counter()
    tree = KT.build(source, tolerance=TREE_TOLERANCE, max_epochs=TREE_EPOCHS)
    build_s = time.perf_counter() - t0
    host_cut = KT.level_cut(tree)
    max_err = KT.measure_max_error(host_cut, source)
    if tree.orig_depth < CD.CHUNKED_DECODE_MIN_DEPTH or max_err > TREE_TOLERANCE:
        raise AssertionError(f"tree: orig_depth {tree.orig_depth}, max error {max_err} (bar "
                             f"{TREE_TOLERANCE})")
    preorder_bytes = (tree.num_active_nodes + 3) // 4
    emit({"phase": "codec", "volume": list(VOLUME), "tolerance": TREE_TOLERANCE,
          "max_epochs": TREE_EPOCHS, "build_s": build_s, "orig_depth": tree.orig_depth,
          "max_depth": tree.max_depth, "num_active_nodes": tree.num_active_nodes,
          "bits_per_voxel": 2 * tree.num_active_nodes / source.size, "max_err": max_err,
          "mean_err": KT.measure_mean_error(host_cut, source), "seed": "csrc/kdtree_seed.cu"})

    # 2. the packed tree on the card, one chunked decode of the full cut
    t0 = time.perf_counter()
    dtree, spec = CD.to_device(tree, dev)
    torch.cuda.synchronize()
    to_device_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    cut = CD.level_cut_device(dtree, spec)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    warm_ms = 1e3 * sweep_seconds(lambda: int(CD.level_cut_device(dtree, spec)[0, 0, 0]))
    if not np.array_equal(cut.cpu().numpy(), host_cut):
        raise AssertionError("device level cut differs from the host level_cut")
    mip8 = CD.tree_occupancy_mip8(dtree, spec)
    if not torch.equal(mip8, RK.block_max8(cut)):
        raise AssertionError("tree_occupancy_mip8 differs from block_max8 of the decoded cut")
    mip8_ms = time_ms(lambda: CD.tree_occupancy_mip8(dtree, spec))
    device_tree_bytes = sum(t.numel() for t in (*dtree.packed_levels, dtree.packed_chains,
                                                dtree.distance_map))
    emit({"phase": "decode", "to_device_ms": to_device_ms, "level_cut_first_ms": first_ms,
          "level_cut_warm_ms": warm_ms, "chunk_leaf_bits": CD.CHUNK_LEAF_BITS,
          "equal_to_host_level_cut": True, "mip8_ms": mip8_ms, "mip8_equal_block_max8": True,
          "device_tree_bytes": device_tree_bytes, "gpu": smi})

    # 3. the slab pools: of the tree's cut (residency from the tree's mip8),
    # and of the dense turbulence and sphere (from their own block maxima)
    dense_u8 = {"turbulence": RK.quantize_u8(turb), "sphere": RK.quantize_u8(sphere)}
    pools = {}
    for name, vol, m8, tree_bytes in (("tree_cut", cut, mip8, preorder_bytes),
                                      ("turbulence", dense_u8["turbulence"], None, 0),
                                      ("sphere", dense_u8["sphere"], None, 0)):
        line = {"phase": "pools", "source": name, "packed_tree_bytes": tree_bytes}
        for fmt, build in (("pair16", RK.build_slab_pool), ("narrow", RK.build_slab_pool_narrow)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool, smap = build(vol, mip8=m8)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            pools[name, fmt] = (pool, smap)
            pool_bytes = nbytes(pool, smap)
            line[fmt] = {"slots": int(pool.shape[0]), "occupied_slabs": int((smap > 0).sum()),
                         "bytes": pool_bytes, "build_ms": ms,
                         "resident_vs_dense_u8": (tree_bytes + pool_bytes) / vol.numel()}
        emit({**line, "gpu": smi})

    # 4. every pooled kernel vs its plain version (the pool sampler through
    # the plain marches) and vs its dense kernel, bit for bit, on the same
    # u8 volume: orbit frames 0 and 15 on the turbulence, the default
    # camera on the sphere (mostly slot-0 reads).  B6 and B7 with the
    # transfer in their epilogue (render_pooled's launch) equal
    # apply_reference_transfer of their color and the fused dense B1 on the
    # float32 volume, bit for bit.
    iso_med = IK.volume_median(turb)
    marches = {"narrow": (RK.composite_march_pooled_narrow_cuda, IK.iso_march_pooled_narrow_cuda),
               "pair16": (RK.composite_march_pooled_pair16_cuda, IK.iso_march_pooled_pair16_cuda)}
    err = {name: 0.0 for name in POOLED_SOURCES}
    plain_inputs = []
    for case, vname, cam, iso in (("orbit_frame0", "turbulence", cameras[0], iso_med),
                                  ("orbit_frame15", "turbulence", cameras[-1], iso_med),
                                  ("entry_sphere", "sphere", Camera(width=W, height=H), 0.5)):
        rays = generate_rays(cam, device=dev)
        plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, VOLUME[::-1])
        vol_u8 = dense_u8[vname]
        args = (plan.entry_uv, plan.dir_step)
        c_d, a_d = RK.composite_march_cuda(vol_u8, *args, plan.hit)
        rgb_f, a_f = RK.composite_march_f32_cuda({"turbulence": turb, "sphere": sphere}[vname],
                                                 *args, plan.hit, transfer=True)
        f_d, t_d = IK.iso_march_cuda(vol_u8, *args, plan.hit, iso)
        dense_grid = plan.bind(vol_u8, iso).grid
        for fmt, (comp, isom) in marches.items():
            pool, smap = pools[vname, fmt]
            sampler = slab_pool_sampler(pool, smap, VOLUME[::-1])
            c_k, a_k = comp(pool, smap, *args, plan.hit)
            rgb_e, a_e = comp(pool, smap, *args, plan.hit, transfer=True)
            f_k, t_k = isom(pool, smap, *args, plan.hit, iso)
            # bound from the pool's own bytes (the grid of the volume it was
            # built from) and from the volume's mip8
            iso_bounds = {"pool": plan.bind(iso_value=iso, pool=(pool, smap)),
                          "mip8": plan.bind(iso_value=iso, pool=(pool, smap),
                                            mip8=RK.block_max8(vol_u8))}
            bound_equal = {"pool_grid_is_volume_grid": bool(torch.equal(iso_bounds["pool"].grid,
                                                                        dense_grid))}
            for bname, ib in iso_bounds.items():
                f_b, t_b = isom(pool, smap, *args, plan.hit, iso, bound=ib)
                bound_equal[bname] = bool(torch.equal(f_b, f_k) and torch.equal(t_b, t_k))
            rgb_k = IK.iso_shade_pooled_cuda(pool, smap, *args, plan.direction, f_k, t_k, iso)
            rgb_d = IK.iso_shade_cuda(vol_u8, *args, plan.direction, f_k, t_k, iso)
            c_p, a_p = composite_march_steps(sampler, *args, plan.hit.bool())
            f_p, t_p = iso_march_steps(sampler, *args, plan.hit.bool(), iso)
            rgb_p = shade_hits(sampler, *args, plan.direction, f_k, t_k, iso)
            torch.cuda.synchronize()
            dense_equal = bool(torch.equal(c_k, c_d) and torch.equal(a_k, a_d)
                               and torch.equal(f_k, f_d) and torch.equal(t_k, t_d)
                               and torch.equal(rgb_k, rgb_d))
            epilogue_equal = bool(torch.equal(rgb_e, apply_reference_transfer(c_k, a_k))
                                  and torch.equal(a_e, a_k) and torch.equal(rgb_e, rgb_f)
                                  and torch.equal(a_e, a_f))
            res = compare((c_k, a_k), (c_p, a_p), W * H)
            px_differ = int(((f_k != f_p) | (t_k != t_p)).sum())
            t_err = float((t_k - t_p).abs().max())
            rgb_err = float((rgb_k - rgb_p).abs().max())
            if not dense_equal or not epilogue_equal or not all(bound_equal.values()) \
                    or px_differ > res["px_allowed"] or rgb_err > ISO_RGB_TOL:
                raise AssertionError(f"pooled {case} {fmt}: equal to the dense kernels "
                                     f"{dense_equal}; the epilogue's image equal to the "
                                     f"transfer's and the fused dense B1's {epilogue_equal}; "
                                     f"bound equal to unbound {bound_equal}; "
                                     f"vs plain {px_differ} px differ in found/t_hit (allowed "
                                     f"{res['px_allowed']:g}), rgb max |d| {rgb_err} (bar "
                                     f"{ISO_RGB_TOL})")
            err[f"composite_march_pooled_{fmt}"] = max(err[f"composite_march_pooled_{fmt}"],
                                                      res["max_abs_err"])
            err[f"iso_march_pooled_{fmt}"] = max(err[f"iso_march_pooled_{fmt}"], t_err)
            err["iso_shade_pooled"] = max(err["iso_shade_pooled"], rgb_err)
            emit({"phase": "pooled_parity", "case": case, "pool": fmt, "iso": iso,
                  "equal_to_dense_kernels": dense_equal,
                  "epilogue_equal_to_transfer_and_fused_b1": epilogue_equal, **res,
                  "iso_px_differ_found_t_hit": px_differ, "t_hit_max_abs_err": t_err,
                  "rgb_max_abs_err": rgb_err, "hits_kernel": int(f_k.sum()),
                  "alpha_sum_kernel": float(a_k.sum()), "bound_bit_equal": bound_equal})
            if case != "entry_sphere":
                plain_inputs.append((fmt, sampler, plan, f_k, t_k))

    # 5. the pooled metrics, bench.py's protocol on the dense turbulence's
    # pools: plan once per camera, min of REPS sweeps after a warm one.  The
    # launch counts cover exactly this run.
    pooled = [RK.composite_march_pooled_narrow_cuda, RK.composite_march_pooled_pair16_cuda,
              IK.iso_march_pooled_narrow_cuda, IK.iso_march_pooled_pair16_cuda,
              IK.iso_shade_pooled_cuda]
    names = list(POOLED_SOURCES)
    for f in pooled:
        f.launches = 0
    renders = dict.fromkeys(names, 0)
    cplans = [RK.CompositingPlan(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]
    iplans = [IK.IsosurfacePlan(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]

    # the isosurface bound from each pool's bytes, once for the pool and
    # isovalue and shared by the plans, and unbound
    pbounds = {fmt: iplans[0].bind(iso_value=iso_med, pool=pools["turbulence", fmt])
               for fmt in ("narrow", "pair16")}

    def sweep(fmt, mode):
        pool, smap = pools["turbulence", fmt]
        acc = torch.zeros((), device=dev)
        for cp, ip in zip(cplans, iplans):
            if mode == "compositing":
                rgb, _ = cp.render_pooled(pool, smap)
                renders[f"composite_march_pooled_{fmt}"] += 1
            else:
                rgb, _ = ip.render_pooled(pool, smap, iso_med,
                                          bound=pbounds[fmt] if mode == "isosurface_bound"
                                          else None)
                renders[f"iso_march_pooled_{fmt}"] += 1
                renders["iso_shade_pooled"] += 1
            acc = acc + rgb.sum()
        return float(acc)

    sweep_s = {(fmt, mode): sweep_seconds(lambda: sweep(fmt, mode))
               for mode in ("compositing", "isosurface", "isosurface_bound")
               for fmt in ("narrow", "pair16")}
    main_launches = {n: f.launches for n, f in zip(names, pooled)}
    if any(main_launches[n] != renders[n] or not renders[n] for n in names):
        raise AssertionError(f"pooled main path: launches {main_launches}, renders {renders}")
    rate = {k: W * H / (v / N_FRAMES) for k, v in sweep_s.items()}
    emit({"phase": "pooled_main_path", "volume": list(VOLUME), "frames": N_FRAMES, "reps": REPS,
          "pooled_rays_per_s_per_chip_1024sq_256cube": rate["narrow", "compositing"],
          "pooled_pair16_rays_per_s_per_chip_1024sq_256cube": rate["pair16", "compositing"],
          "pooled_iso_rays_per_s_per_chip_1024sq_256cube": rate["narrow", "isosurface"],
          "pooled_pair16_iso_rays_per_s_per_chip_1024sq_256cube": rate["pair16", "isosurface"],
          "pooled_iso_bound_rays_per_s": {fmt: rate[fmt, "isosurface_bound"]
                                          for fmt in ("narrow", "pair16")},
          "ms_per_frame": {f"{mode}_{fmt}": 1e3 * v / N_FRAMES
                           for (fmt, mode), v in sweep_s.items()},
          "iso": iso_med, "launches": main_launches, "renders": dict(renders), "gpu": smi})

    # 6. the user's path: CompressedRenderer.make_plan(pooled=True) over the
    # orbit, compositing (B7) and the isosurface at the cut's median (B8,
    # pooled shade); every frame equal to make_plan(pooled=False) on the
    # same cut, rendered by a second renderer so that the first keeps no
    # dense volume.  The launch counts cover the sweeps.
    ren = CompressedRenderer(tree, dev)
    ref = CompressedRenderer(tree, dev)
    iso_cut = IK.volume_median(ref.volume_at())
    for f in pooled:
        f.launches = 0
    comp_renders = dict.fromkeys(names, 0)
    t0 = time.perf_counter()
    frames = {mode: [ren.make_plan(r, mode=mode, iso_value=iso_cut, pooled=True)
                     for r in bundles] for mode in ("compositing", "isosurface")}
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0

    def user_sweep(mode):
        acc = torch.zeros((), device=dev)
        for render in frames[mode]:
            rgb, _ = render()
            acc = acc + rgb.sum()
            if mode == "compositing":
                comp_renders["composite_march_pooled_pair16"] += 1
            else:
                comp_renders["iso_march_pooled_narrow"] += 1
                comp_renders["iso_shade_pooled"] += 1
        return float(acc)

    user_s = {mode: sweep_seconds(lambda: user_sweep(mode)) for mode in frames}
    comp_launches = {n: f.launches for n, f in zip(names, pooled)}
    if any(comp_launches[n] != comp_renders[n] for n in names) \
            or not comp_renders["composite_march_pooled_pair16"] \
            or not comp_renders["iso_march_pooled_narrow"]:
        raise AssertionError(f"compressed main path: launches {comp_launches}, renders "
                             f"{comp_renders}")
    if ren._cache:
        raise AssertionError("the pooled renderer kept a dense volume")
    n_equal = 0
    for mode in frames:
        for render, r in zip(frames[mode], bundles):
            out = render()
            want = ref.make_plan(r, mode=mode, iso_value=iso_cut)()
            if not all(torch.equal(a, b) for a, b in zip(out, want)):
                raise AssertionError(f"compressed {mode} frame differs from the dense plan")
            if not bool(torch.isfinite(out[0]).all()) or out[0].shape != (H, W, 3):
                raise AssertionError(f"compressed {mode} frame: not finite or misshapen")
            n_equal += 1
    pool16, _ = ren.slab_pool_at(fmt="pair16")
    pooln, _ = ren.slab_pool_at(fmt="narrowf32")
    emit({"phase": "compressed_main_path", "frames": N_FRAMES, "reps": REPS,
          "ms_per_frame": {m: 1e3 * v / N_FRAMES for m, v in user_s.items()},
          "rays_per_s": {m: W * H / (v / N_FRAMES) for m, v in user_s.items()},
          "plan_and_pools_s": plan_s, "iso_cut_median": iso_cut,
          "frames_equal_to_dense_plan": n_equal,
          "resident_pool_bytes": {"pair16": pool16.numel() * 4, "narrowf32": pooln.numel() * 4},
          "dense_volume_kept": False, "launches": comp_launches, "renders": comp_renders,
          "gpu": smi})

    # 7. per-launch times over the orbit on the dense turbulence's pools, and
    # the plain versions on frames 0 and 15 only (a plain iso march takes
    # ~0.25 s a frame); the dense kernels' times of this run beside them
    pool_n, smap_n = pools["turbulence", "narrow"]
    pool_16, smap_16 = pools["turbulence", "pair16"]
    hits = [IK.iso_march_pooled_narrow_cuda(pool_n, smap_n, p.entry_uv, p.dir_step, p.hit,
                                            iso_med) for p in iplans]

    def per_frame(fn, plans):
        return time_ms(lambda: [fn(p) for p in plans]) / len(plans)

    # B6 and B7 as render_pooled launches them (the transfer in the
    # epilogue), the color alone beside them
    color_ms = {
        "composite_march_pooled_narrow": per_frame(
            lambda p: RK.composite_march_pooled_narrow_cuda(pool_n, smap_n, p.entry_uv,
                                                            p.dir_step, p.hit), cplans),
        "composite_march_pooled_pair16": per_frame(
            lambda p: RK.composite_march_pooled_pair16_cuda(pool_16, smap_16, p.entry_uv,
                                                            p.dir_step, p.hit), cplans)}
    ms = {
        "composite_march_pooled_narrow": per_frame(
            lambda p: RK.composite_march_pooled_narrow_cuda(pool_n, smap_n, p.entry_uv,
                                                            p.dir_step, p.hit, transfer=True),
            cplans),
        "composite_march_pooled_pair16": per_frame(
            lambda p: RK.composite_march_pooled_pair16_cuda(pool_16, smap_16, p.entry_uv,
                                                            p.dir_step, p.hit, transfer=True),
            cplans),
        "iso_march_pooled_narrow": per_frame(
            lambda p: IK.iso_march_pooled_narrow_cuda(pool_n, smap_n, p.entry_uv, p.dir_step,
                                                      p.hit, iso_med), iplans),
        "iso_march_pooled_pair16": per_frame(
            lambda p: IK.iso_march_pooled_pair16_cuda(pool_16, smap_16, p.entry_uv,
                                                      p.dir_step, p.hit, iso_med), iplans),
        "iso_shade_pooled": time_ms(lambda: [
            IK.iso_shade_pooled_cuda(pool_n, smap_n, p.entry_uv, p.dir_step, p.direction, f, t,
                                     iso_med) for p, (f, t) in zip(iplans, hits)]) / N_FRAMES}
    # B8 and B9 bound from their pool's grid (B2's grid and positions, so
    # B2's gathers)
    bound_ms = {
        f"iso_march_pooled_{fmt}": time_ms(
            lambda: [march(pool, smap, p.entry_uv, p.dir_step, p.hit, iso_med,
                           bound=pbounds[fmt]) for p in iplans]) / N_FRAMES
        for fmt, march, (pool, smap) in (
            ("narrow", IK.iso_march_pooled_narrow_cuda, (pool_n, smap_n)),
            ("pair16", IK.iso_march_pooled_pair16_cuda, (pool_16, smap_16)))}
    plain_ms = dict.fromkeys(names, 0.0)
    for fmt, sampler, plan, f_k, t_k in plain_inputs:
        args = (plan.entry_uv, plan.dir_step)
        plain_ms[f"composite_march_pooled_{fmt}"] += time_ms(
            lambda: composite_march_steps(sampler, *args, plan.hit.bool()), reps=1) / 2
        plain_ms[f"iso_march_pooled_{fmt}"] += time_ms(
            lambda: iso_march_steps(sampler, *args, plan.hit.bool(), iso_med), reps=1) / 2
        if fmt == "narrow":
            plain_ms["iso_shade_pooled"] += time_ms(
                lambda: shade_hits(sampler, *args, plan.direction, f_k, t_k, iso_med),
                reps=1) / 2
    emit({"phase": "pooled_timing", "shape": [H, W], "volume": list(VOLUME), "iso": iso_med,
          "frames": N_FRAMES, "plain_frames": [0, N_FRAMES - 1],
          "kernel_ms_per_launch": ms, "color_only_ms_per_launch": color_ms,
          "bound_kernel_ms_per_launch": bound_ms,
          "plain_ms_per_launch": plain_ms,
          "dense_kernel_ms_per_launch": {n: e["ms"] for n, e in dense.items()},
          "dense_iso_march_ms_unbound": dense["iso_march"]["ms_unbound"], "gpu": smi})

    launches = {n: main_launches[n] + comp_launches[n] for n in names}
    emit({"phase": "pooled_launch_count", "pooled_main_path": main_launches,
          "compressed_main_path": comp_launches, "renders": {
              n: renders[n] + comp_renders[n] for n in names}})
    # the bounds: the pool and map in place of the volume, the dense kernels'
    # samples and operations
    pool_io = {fmt: nbytes(*pools["turbulence", fmt]) for fmt in ("narrow", "pair16")}
    rays_io = sum(nbytes(p.entry_uv, p.dir_step, p.hit) for p in iplans) / N_FRAMES
    iso, shade = dense["iso_march"], dense["iso_shade"]
    hit_io = sum(nbytes(f, t) for f, t in hits) / N_FRAMES

    def like(entry, n_bytes):
        return bound(n_bytes, entry["ops"], entry["samples_per_ray"] * W * H, W * H)

    # B6/B7: the dense march's samples on byte taps, the image written; the
    # pool words their taps fetch over the orbit (a boolean scatter of every
    # sample's 4 word indices, per frame), as B1's bound counts its voxels,
    # the whole pool's bytes beside it
    comp_ops = OPS_PER_STEP["composite"] * samples + TRANSFER_OPS_PER_RAY * W * H
    turb_plain = as_normalized_volume(dense_u8["turbulence"])
    words = dict.fromkeys(pool_io, 0.0)
    for p in cplans:
        masks = {fmt: torch.zeros(pools["turbulence", fmt][0].numel(), dtype=torch.bool,
                                  device=dev) for fmt in pool_io}
        composite_samples(p, turb_plain, pools=[(masks[fmt], *pools["turbulence", fmt])
                                                for fmt in pool_io])
        for fmt in pool_io:
            words[fmt] += float(masks[fmt].sum()) / N_FRAMES
    out_io = rays_io + RGBA_BYTES * W * H
    bounds = {}
    for fmt in pool_io:
        pool, smap = pools["turbulence", fmt]
        n = f"composite_march_pooled_{fmt}"
        bounds[n] = {**bound(words[fmt] * pool.element_size() + nbytes(smap) + out_io, comp_ops,
                             samples, W * H),
                     "touched_pool_words_per_launch": words[fmt],
                     "bound_ms_whole_pool": bound(pool_io[fmt] + out_io, comp_ops, samples,
                                                  W * H)["bound_ms"],
                     "color_only_ms": color_ms[n]}
    bounds.update({f"iso_march_pooled_{fmt}": bound(pool_io[fmt] + rays_io + hit_io,
                                                    iso["ops_unskipped_formula"],
                                                    iso["samples_per_ray"] * W * H, W * H)
                   for fmt in pool_io})
    shade_io = sum(nbytes(p.entry_uv, p.dir_step, p.direction) for p in iplans) / N_FRAMES
    bounds["iso_shade_pooled"] = like(shade, pool_io["narrow"] + shade_io + hit_io + 12 * W * H)
    # ms and bound_ms are the unbound march's (the compressed path binds
    # nothing yet); the bound march gathers what B2's does, its bound from
    # B2's bound operations and the pool's bytes
    for fmt in pool_io:
        n = f"iso_march_pooled_{fmt}"
        by = like(iso, pool_io[fmt] + rays_io + hit_io + nbytes(pbounds[fmt].grid))
        bounds[n].update({"ms_bound": bound_ms[n], "bound_ms_bound": by["bound_ms"],
                          "gathered_per_ray": iso["gathered_per_ray"]})
    return [{"name": n, "route": "cuda", "source": POOLED_SOURCES[n],
             "replaces": POOLED_REPLACES[n], "launches": launches[n], "max_abs_err": err[n],
             "ms": ms[n], "plain_ms": plain_ms[n], **bounds[n]} for n in names]


def run_sharded(dev, smi: str, turb, sphere, cameras, bundles) -> list:
    """The volume-sharded phases; returns the kernels line's three entries."""
    from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.diff.closed_form import seg_tf_march_steps, tf_scalars
    from volumerenderer_tpu_torch.models import plan_compositing
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.cuda import seg_kernel as SK
    from volumerenderer_tpu_torch.ops.cuda import tf_kernel as TK
    from volumerenderer_tpu_torch.ops.cuda import voxel_grad_kernel as VK
    from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import quantize_u8
    from volumerenderer_tpu_torch.ops.raycast import (ALPHA_SCALE, EARLY_OUT_ALPHA,
                                                      apply_reference_transfer, seg_entry_table,
                                                      seg_march_steps)
    from volumerenderer_tpu_torch.ops.sampling import shard_sampler
    from volumerenderer_tpu_torch.parallel import bricks as PB
    from volumerenderer_tpu_torch.parallel import context as PC
    from volumerenderer_tpu_torch.parallel import kernel_sharded as KS
    from volumerenderer_tpu_torch.parallel import sharding as PS

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    # the layouts over the host's cards (round-robin: all four shards share
    # the card of a one-card host), each volume split once
    meshes = {"z4": PC.make_z_mesh(Z_SHARDS), "bricks221": PB.make_brick_mesh(BRICKS)}
    render = {"z4": KS.render_zsharded_kernel, "bricks221": KS.render_bricksharded_kernel}
    volumes = {name: PB.shard_volume(mesh, turb) for name, mesh in meshes.items()}
    shard_devices = {name: [str(b.device) for b in sv.bricks.flat] for name, sv in volumes.items()}
    non_reference = TFParams(*(f32(v) for v in NON_REFERENCE_TF))
    tf = tf_scalars(non_reference)

    def box(kw):
        return kw["z_lo"], kw["z_lo"] + kw["n_z"], kw["y_lo"], kw["y_lo"] + kw["n_y"]

    def rays_on(plan, device):
        return [t.to(device) for t in (plan.entry_uv, plan.dir_step, plan.hit)]

    def plain(slab, plan, kw, tf_scalars=None):
        e, d, h = rays_on(plan, slab.device)
        sample = shard_sampler(as_normalized_volume(slab), kw["dims"], kw["z_lo"], kw["y_lo"])
        if tf_scalars is None:
            return seg_march_steps(sample, e, d, h.bool(), kw["dims"], box(kw), kw["max_samples"])
        return seg_tf_march_steps(sample, e, d, h.bool(), tf_scalars.to(slab.device), kw["dims"],
                                  box(kw), kw["max_samples"])

    def plain_table(plan, kw, device):
        e, d, h = rays_on(plan, device)
        return seg_entry_table(e, d, h.bool(), kw["dims"], box(kw), kw["max_samples"])

    # 1. every shard's entry table, B10 and B11 against their plain versions
    # on the same inputs, both layouts: orbit frames 0 and 15 and the
    # sphere; B11 at non-reference params.  All bit for bit: the table's
    # positions and indices, every plane of B10 and B11 (the walking plain
    # marches; the kernels from the kernel's table).
    err = {"seg_march": 0.0, "seg_tf_march": 0.0, "seg_entry_table": 0.0}
    for case, v, cam in (("orbit_frame0", turb, cameras[0]),
                         ("orbit_frame15", turb, cameras[-1]),
                         ("entry_sphere", sphere, Camera(width=W, height=H))):
        rays = generate_rays(cam, device=dev)
        plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, VOLUME[::-1])
        for layout, mesh in meshes.items():
            for shard, (slab, kw) in enumerate(KS.seg_shards(mesh, plan, v)):
                st = SK.seg_entry_table_cuda(*rays_on(plan, slab.device), **kw)
                pe = plain_table(plan, kw, slab.device)
                k = SK.seg_march_cuda(slab, *rays_on(plan, slab.device), **kw, starts=st)
                p = plain(slab, plan, kw)
                kt = SK.seg_tf_march_cuda(slab, *rays_on(plan, slab.device), tf.to(slab.device),
                                          **kw, starts=st)
                pt = plain(slab, plan, kw, tf)
                torch.cuda.synchronize()
                i0_k, i0_p = (t[..., 3].contiguous().view(torch.int32) for t in (st.entry, pe))
                table_err = max(float((st.entry[..., :3] - pe[..., :3]).abs().max()),
                                float((i0_k - i0_p).abs().max()))
                equal = {"table": torch.equal(st.entry.view(torch.int32), pe.view(torch.int32)),
                         "b10": all(torch.equal(a, b) for a, b in zip(k, p)),
                         "b11": all(torch.equal(a, b) for a, b in zip(kt, pt))}
                if not all(equal.values()):
                    raise AssertionError(f"sharded {case} {layout} shard {shard}: bit-equal "
                                         f"{equal}")
                b10 = {n: {"max_abs_err": float((a - b).abs().max()), "px_differ": int((a != b).sum())}
                       for n, a, b in zip(("C", "alpha", "t_first"), k, p)}
                b11_err = max(float((a - b).abs().max()) for i, (a, b) in enumerate(zip(kt, pt))
                              if i != 2)
                err["seg_entry_table"] = max(err["seg_entry_table"], table_err)
                err["seg_march"] = max(err["seg_march"], b10["C"]["max_abs_err"],
                                       b10["alpha"]["max_abs_err"])
                err["seg_tf_march"] = max(err["seg_tf_march"], b11_err)
                emit({"phase": "sharded_parity", "case": case, "layout": layout, "shard": shard,
                      "box": list(box(kw)), "slab": list(slab.shape), "device": str(slab.device),
                      "bit_equal": equal, "table_max_abs_err": table_err, "b10": b10,
                      "b11_max_abs_err_8": b11_err, "owned_rays": int((k[2] < 1e9).sum())})

    # 2. the main path, as a user drives it: camera -> rays -> plan (once per
    # camera) -> render per frame, both layouts, beside the dense plan's
    # frame; min of REPS sweeps after a warm sweep.  A camera's first frame
    # builds its shards' entry tables, which its plan keeps.  The launch
    # count covers the sweeps and the checks after them, which leave each
    # plan holding its tables of both layouts (their bytes printed).  Then
    # the same sweeps with the tables rebuilt inside each frame, as a camera
    # seen once pays them, not counted.
    plans = [plan_compositing(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]
    SK.seg_march_cuda.launches = 0
    SK.seg_entry_table_cuda.launches = 0
    renders = dict.fromkeys(meshes, 0)

    def sweep(layout):
        acc = torch.zeros((), device=dev)
        for plan in plans:
            rgb, _ = render[layout](meshes[layout], plan, volumes[layout])
            renders[layout] += 1
            acc = acc + rgb.sum()
        return float(acc)

    def dense_sweep():
        acc = torch.zeros((), device=dev)
        for plan in plans:
            acc = acc + plan.render(turb)[0].sum()
        return float(acc)

    sweep_s = {layout: sweep_seconds(lambda: sweep(layout)) for layout in meshes}
    dense_s = sweep_seconds(dense_sweep)
    tau0 = 1.0 - EARLY_OUT_ALPHA
    bars = {"rgb": tau0 / ALPHA_SCALE + 1e-5, "alpha": tau0 + 1e-5, "layouts": 1e-5}
    worst = {"rgb": 0.0, "alpha": 0.0, "layouts": 0.0}
    for plan in plans:
        rgb_d, a_d = plan.render(turb)
        frames = {}
        for layout in meshes:
            frames[layout] = render[layout](meshes[layout], plan, volumes[layout])
            renders[layout] += 1
            rgb, a = frames[layout]
            if rgb.shape != (H, W, 3) or not bool(torch.isfinite(rgb).all()):
                raise AssertionError(f"sharded {layout} frame: misshapen or not finite")
            worst["rgb"] = max(worst["rgb"], float((rgb - rgb_d).abs().max()))
            worst["alpha"] = max(worst["alpha"], float((a - a_d).abs().max()))
        worst["layouts"] = max(worst["layouts"], *(float((x - y).abs().max()) for x, y in
                                                   zip(frames["z4"], frames["bricks221"])))
    if any(worst[n] > bars[n] for n in bars):
        raise AssertionError(f"sharded frames: max |d| {worst}, bars {bars}")
    main_launches, main_renders = SK.seg_march_cuda.launches, dict(renders)
    table_launches = SK.seg_entry_table_cuda.launches
    want_launches = sum(renders[n] * meshes[n].size for n in meshes)
    want_tables = len(plans) * sum(m.size for m in meshes.values())
    cache_bytes = [sum(nbytes(st.entry) for st in p.seg_starts.values()) for p in plans]

    def rebuilt_sweep(layout):
        acc = torch.zeros((), device=dev)
        for plan in plans:
            plan.seg_starts.clear()
            acc = acc + render[layout](meshes[layout], plan, volumes[layout])[0].sum()
        return float(acc)

    rebuilt_s = {layout: sweep_seconds(lambda: rebuilt_sweep(layout)) for layout in meshes}
    emit({"phase": "sharded_main_path", "volume": list(VOLUME), "frames": N_FRAMES, "reps": REPS,
          "ms_per_frame": {n: 1e3 * s / N_FRAMES for n, s in sweep_s.items()},
          "ms_per_frame_tables_rebuilt": {n: 1e3 * s / N_FRAMES for n, s in rebuilt_s.items()},
          "table_launches": table_launches, "tables_cameras_x_shards": want_tables,
          "table_cache_bytes_per_plan_both_layouts": max(cache_bytes),
          "table_cache_bytes_all_plans": sum(cache_bytes),
          "rays_per_s": {n: W * H / (s / N_FRAMES) for n, s in sweep_s.items()},
          "dense_plan_ms_per_frame": 1e3 * dense_s / N_FRAMES,
          "dense_plan_rays_per_s": W * H / (dense_s / N_FRAMES),
          "max_abs_vs_dense_and_between_layouts": worst, "bars": bars,
          "device_count": torch.cuda.device_count(), "shard_devices": shard_devices,
          "gpu": smi})

    # 3. the brick-sharded TF fit at orbit frame 0 (B11): the loss falls over
    # FIT_STEPS; one step at non-reference params matches the single-device
    # fit step on the volume dimmed until that render's max alpha stays at
    # or below 0.99 (no early-out to lose).
    SK.seg_tf_march_cuda.launches = 0
    fit_steps = 0
    plan0, bmesh = plans[0], meshes["bricks221"]
    target = torch.full((H, W, 3), 0.5, device=dev)
    params, losses = TFParams.reference(dev), []
    for _ in range(FIT_STEPS):
        params, loss = KS.tf_fit_step_bricksharded(bmesh, plan0, params, volumes["bricks221"],
                                                   target, lr=FIT_LR)
        fit_steps += 1
        losses.append(float(loss))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"brick-sharded TF fit losses {losses}: not finite or not lowered")
    scale = 1.0
    while True:
        dim = turb * scale
        max_alpha = float(TK.render_tf_grads_kernel(non_reference, dim, plan0)[1].max())
        if max_alpha <= EARLY_OUT_ALPHA:
            break
        scale *= 0.5
    new_s, loss_s = KS.tf_fit_step_bricksharded(bmesh, plan0, non_reference,
                                                PB.shard_volume(bmesh, dim), target, lr=FIT_LR)
    fit_steps += 1
    new_1, loss_1 = TK.tf_fit_step_fast(TK.make_render_tf_kernel(plan0), non_reference, dim,
                                        target, lr=FIT_LR)
    loss_rel = abs(float(loss_s) - float(loss_1)) / abs(float(loss_1))
    param_err = {n: float(((a - b).abs() - 1e-4 * b.abs()).max())
                 for n, a, b in zip(TFParams._fields, new_s, new_1)}
    if loss_rel > 1e-5 or max(param_err.values()) > 1e-6:
        raise AssertionError(f"brick-sharded fit step vs single device: loss rel {loss_rel} "
                             f"(bar 1e-5), params |d| - 1e-4 |p| {param_err} (bar 1e-6)")
    fit_launches = SK.seg_tf_march_cuda.launches
    emit({"phase": "sharded_fit", "layout": "bricks221", "fit_losses": losses, "fit_lr": FIT_LR,
          "dim_scale": scale, "dim_max_alpha_single_device": max_alpha,
          "step_loss_sharded": float(loss_s), "step_loss_single": float(loss_1),
          "step_loss_rel_err": loss_rel, "step_param_err_beyond_rtol_1e-4": param_err,
          "gpu": smi})

    # 4. the row-sharded paths on the kernels already ported: image rows over
    # a 4-device mesh, each shard launching B1, B4 or B5 on its rows.  The
    # orbit renders equal plan.render bit for bit; one TF-fit step and one
    # voxel-fit step match the single-device steps.  The launches are counted
    # over the sharded calls alone, before the references run.
    rmesh = PS.make_mesh(4)
    n_rows = len(rmesh.axis_devices("rays"))
    reference = TFParams.reference(dev)
    row_kernels = {"composite_march": RK.composite_march_cuda, "tf_march": TK.tf_march_cuda,
                   "voxel_grad": VK.voxel_grad_cuda}
    for f in row_kernels.values():
        f.launches = 0
    row_frames = [KS.render_planned_sharded(rmesh, plan, turb) for plan in plans]
    new_k, loss_k = KS.tf_fit_step_kernel(rmesh, plan0, non_reference, turb, target, lr=FIT_LR)
    new_p, new_v, loss_v = KS.voxel_fit_step_kernel(rmesh, plan0, reference, turb, target)
    row_launches = {n: f.launches for n, f in row_kernels.items()}
    row_want = {"composite_march": n_rows * len(plans), "tf_march": 2 * n_rows,
                "voxel_grad": n_rows}
    if row_launches != row_want:
        raise AssertionError(f"row-sharded paths: launches {row_launches}, want {row_want}")
    row_px = 0
    for plan, (rgb_s, a_s) in zip(plans, row_frames):
        rgb_d, a_d = plan.render(turb)
        row_px += int((rgb_s != rgb_d).any(dim=-1).sum()) + int((a_s != a_d).sum())
    if row_px:
        raise AssertionError(f"row-sharded orbit renders differ from plan.render on {row_px} px")
    new_f, loss_f = TK.tf_fit_step_fast(TK.make_render_tf_kernel(plan0), non_reference, turb,
                                        target, lr=FIT_LR)
    row_loss_rel = abs(float(loss_k) - float(loss_f)) / abs(float(loss_f))
    row_param_err = {n: float(((a - b).abs() - 1e-4 * b.abs()).max())
                     for n, a, b in zip(TFParams._fields, new_k, new_f)}
    if row_loss_rel > 1e-5 or max(row_param_err.values()) > 1e-6:
        raise AssertionError(f"row-sharded TF fit step vs single device: loss rel {row_loss_rel} "
                             f"(bar 1e-5), params |d| - 1e-4 |p| {row_param_err} (bar 1e-6)")
    leaves = TFParams(*(t.clone().requires_grad_(True) for t in reference))
    vt = turb.clone().requires_grad_(True)
    rgb, _ = VK.make_render_tf_voxel(plan0)(leaves, vt)
    loss_1v = torch.mean((rgb - target) ** 2)
    *gp, gv = torch.autograd.grad(loss_1v, [*leaves, vt])
    ref_v = torch.clamp(turb - 0.1 * gv, 0.0, 1.0)
    vox_err = {"volume": float(((new_v - ref_v).abs() - 1e-4 * ref_v.abs()).max()),
               **{n: float(((a - (p - 1e-2 * g)).abs() - 1e-4 * (p - 1e-2 * g).abs()).max())
                  for n, a, p, g in zip(TFParams._fields, new_p, reference, gp)}}
    vox_loss_rel = abs(float(loss_v) - float(loss_1v.detach())) / float(loss_1v.detach())
    if vox_loss_rel > 1e-5 or max(vox_err.values()) > 1e-6:
        raise AssertionError(f"row-sharded voxel fit step vs single device: loss rel "
                             f"{vox_loss_rel}, |d| - 1e-4 |ref| {vox_err} (bar 1e-6)")
    emit({"phase": "sharded_rows", "mesh": rmesh.shape,
          "shard_devices": [str(d) for d in rmesh.axis_devices("rays")],
          "orbit_frames": len(plans), "render_px_differ": row_px,
          "tf_fit_loss_rel_err": row_loss_rel, "tf_fit_err_beyond_rtol_1e-4": row_param_err,
          "voxel_fit_loss_rel_err": vox_loss_rel, "voxel_fit_err_beyond_rtol_1e-4": vox_err,
          "launches": row_launches, "shards_x_calls": row_want, "gpu": smi})

    # 5. per-launch times of the entry table, B10 and B11 (from the cached
    # tables) over the orbit, both layouts, and of their plain versions on
    # orbit frame 0; the bounds from the same inputs
    shards = {n: KS.seg_shards(m, plan0, volumes[n]) for n, m in meshes.items()}
    n_launch = N_FRAMES * Z_SHARDS
    names = ("seg_march", "seg_tf_march", "seg_entry_table")
    ms = {name: {} for name in names}
    plain_ms = {name: {} for name in names}
    for n, sh in shards.items():
        on = [(slab, kw, rays_on(p, slab.device), tf.to(slab.device),
               KS.shard_starts(p, kw, slab.device)) for p in plans for slab, kw in sh]
        ms["seg_march"][n] = time_ms(lambda: [SK.seg_march_cuda(s, *r, **kw, starts=st)
                                              for s, kw, r, _, st in on]) / n_launch
        ms["seg_tf_march"][n] = time_ms(lambda: [SK.seg_tf_march_cuda(s, *r, t, **kw, starts=st)
                                                 for s, kw, r, t, st in on]) / n_launch
        ms["seg_entry_table"][n] = time_ms(lambda: [SK.seg_entry_table_cuda(*r, **kw)
                                                    for _, kw, r, _, _ in on]) / n_launch
        plain_ms["seg_march"][n] = time_ms(lambda: [plain(s, plan0, kw) for s, kw in sh],
                                           reps=1) / len(sh)
        plain_ms["seg_tf_march"][n] = time_ms(lambda: [plain(s, plan0, kw, tf) for s, kw in sh],
                                              reps=1) / len(sh)
        plain_ms["seg_entry_table"][n] = time_ms(
            lambda: [plain_table(plan0, kw, s.device) for s, kw in sh], reps=1) / len(sh)
    emit({"phase": "sharded_timing", "shape": [H, W], "volume": list(VOLUME), "frames": N_FRAMES,
          "plain_frames": [0], "kernel_ms_per_launch": ms, "plain_ms_per_launch": plain_ms,
          "dense_b1_ms_per_launch_this_run": time_ms(lambda: [
              p.render(turb) for p in plans]) / N_FRAMES, "gpu": smi})
    boxes = [box(kw) for sh in shards.values() for _, kw in sh]
    steps = torch.zeros((3, len(boxes)), dtype=torch.float64)
    for p in plans:
        steps += torch.stack([t.sum(dim=(1, 2)).double().cpu() for t in march_steps(p, boxes)])
    walked, owned, entered = (float(t.sum()) for t in steps)
    n_all = N_FRAMES * len(boxes)
    # B10/B11 from the table: each input read once (the slab, the table's
    # 16 bytes and dir_step's 12 per ray, B11's 3 TF scalars), each output
    # plane written once, and per owned step a position step and anchor
    # test (9) and the sample and sums; the table reads the rays, writes its
    # 16 bytes per ray and takes its steps up to the first owned one.  The
    # walking formula (the bound before the table, kept so that earlier
    # shares of bound compare) adds 9 ops for every step a walking march
    # takes and reads entry_uv and hit in place of the table.
    slab_io = sum(nbytes(s) for sh in shards.values() for s, _ in sh) / len(boxes)
    rays_io = sum(nbytes(p.entry_uv, p.dir_step, p.hit) for p in plans) / N_FRAMES
    march_io = sum(nbytes(p.dir_step) for p in plans) / N_FRAMES + 16 * W * H
    walk = OPS_PER_STEP["seg_walk"]
    owned_n, walked_n, entered_n = owned / n_all, walked / n_all, entered / n_all  # per launch
    bounds = {}
    for name, planes, extra, key in (("seg_march", 3, 0, "seg_owned"),
                                     ("seg_tf_march", 8, 12, "seg_tf_owned")):
        out_io = planes * 4 * W * H + extra
        bounds[name] = bound(slab_io + march_io + out_io, (walk + OPS_PER_STEP[key]) * owned_n,
                             owned_n, W * H)
        bounds[name]["bound_ms_walking_formula"] = bound(
            slab_io + rays_io + out_io, walk * walked_n + OPS_PER_STEP[key] * owned_n, owned_n,
            W * H)["bound_ms"]
    bounds["seg_entry_table"] = bound(rays_io + 16 * W * H, walk * entered_n, entered_n, W * H)
    # the entry table per layout: build time per camera, the steps a ray
    # takes per shard (walked by a walking march, owned, walked by the table)
    first = 0
    for n, sh in shards.items():
        per = steps[:, first:first + len(sh)].sum(dim=1) / (N_FRAMES * len(sh) * W * H)
        first += len(sh)
        emit({"phase": "seg_starts", "layout": n, "shards": len(sh),
              "table_ms_per_camera": ms["seg_entry_table"][n] * len(sh),
              "table_ms_per_launch": ms["seg_entry_table"][n],
              "plain_table_ms_per_launch": plain_ms["seg_entry_table"][n],
              "steps_per_ray_per_shard": {"walked": float(per[0]), "owned": float(per[1]),
                                          "table": float(per[2])},
              "gpu": smi})

    # 6. one sharded frame (orbit frame 0) split into its layers
    for n, mesh in meshes.items():
        sv, sh = volumes[n], shards[n]
        u8 = np.empty(sv.bricks.shape, dtype=object)
        for idx in np.ndindex(*u8.shape):
            u8[idx] = quantize_u8(sv.bricks[idx])
        axes = (0, 1) if sv.bricks.shape[1] > 1 else (0,)
        on = [(s, kw, rays_on(plan0, s.device), KS.shard_starts(plan0, kw, s.device))
              for s, kw in sh]
        outs = [SK.seg_march_cuda(s, *r, **kw, starts=st) for s, kw, r, st in on]
        C, A, T = (torch.stack([o[i].to(mesh.first) for o in outs]) for i in range(3))
        c, a = PB.composite_segments_ordered(C, 1.0 - A, T)
        emit({"phase": "sharded_layers", "layout": n, "ms": {
            "quantize_shards": time_ms(lambda: [quantize_u8(b) for b in sv.bricks.flat]),
            "halo_exchange": time_ms(lambda: PB.extend_halos(u8, axes)),
            "entry_tables_once_per_camera": time_ms(
                lambda: [SK.seg_entry_table_cuda(*r, **kw) for _, kw, r, _ in on]),
            "seg_march_launches": time_ms(
                lambda: [SK.seg_march_cuda(s, *r, **kw, starts=st) for s, kw, r, st in on]),
            "compose": time_ms(lambda: PB.composite_segments_ordered(C, 1.0 - A, T)),
            "transfer": time_ms(lambda: apply_reference_transfer(c, a)),
            "whole_frame_events": time_ms(lambda: render[n](mesh, plan0, sv))},
            "orbit_sweep_profile": device_profile(lambda: sweep(n)),
            "shards": len(sh), "gpu": smi})

    # 7. the main path went through B10 once per shard and render and the
    # entry table once per shard and camera, the fit through B11 once per
    # shard and step (the row-sharded counts: phase 4)
    want_fit = fit_steps * bmesh.size
    if main_launches != want_launches or not renders["z4"] or fit_launches != want_fit \
            or table_launches != want_tables:
        raise AssertionError(f"segment kernels: B10 {main_launches} launches for "
                             f"{want_launches}, B11 {fit_launches} for {want_fit}, entry table "
                             f"{table_launches} for {want_tables}")
    emit({"phase": "sharded_launch_count", "seg_march": main_launches,
          "shards_x_renders": want_launches, "renders": main_renders,
          "seg_entry_table": table_launches, "cameras_x_shards": want_tables,
          "seg_tf_march": fit_launches, "shards_x_fit_steps": want_fit, "fit_steps": fit_steps,
          "row_sharded": row_launches})
    launches = {"seg_march": main_launches, "seg_tf_march": fit_launches,
                "seg_entry_table": table_launches}
    return [{"name": name, "route": "cuda", "source": SEG_SOURCE,
             "replaces": SEG_REPLACES[name], "launches": launches[name],
             "max_abs_err": err[name], "ms": sum(ms[name].values()) / len(ms[name]),
             "plain_ms": sum(plain_ms[name].values()) / len(plain_ms[name]), **bounds[name]}
            for name in names]


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
    from volumerenderer_tpu_torch.ops.cuda import seg_kernel as SK
    from volumerenderer_tpu_torch.ops.cuda import tf_kernel as TK
    from volumerenderer_tpu_torch.ops.cuda import voxel_grad_kernel as VK
    from volumerenderer_tpu_torch.ops.raycast import apply_reference_transfer, composite_march_steps

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
    _build.load_many(["composite_march", "iso_march", "iso_shade", "tf_march", "voxel_grad",
                      "kdtree_seed", "seg_march"])
    libraries = {"composite_march": RK.load_kernel(), **IK.load_kernels(),
                 "tf_march": TK.load_kernel(), "voxel_grad": VK.load_kernel(),
                 "kdtree_seed": _build.load("kdtree_seed"), "seg_march": SK.load_kernel()}
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

    # 4. kernel vs plain march on the card, same inputs, at the main path's
    # shapes: the fused B1 (the float32 volume, each tap quantized as it is
    # read, the transfer in its epilogue) and the byte route (B1 on
    # quantize_u8 of the volume) against the plain march on quantize_u8 of
    # the volume and apply_reference_transfer, bit for bit; on the four
    # cases of the earlier slices and on a volume made to part a per-tap
    # quantize from quantize_u8 (values below 0, above 1 and at (k + 0.5)/255
    # and one ulp either side), both wraps
    sphere = as_normalized_volume(sphere_volume(VOLUME), device=dev)
    turb = as_normalized_volume(turbulence_volume(VOLUME, seed=0), device=dev)
    adversarial = adversarial_volume(dev)
    cases = [("entry_sphere", sphere, Camera(width=W, height=H), "clamp"),
             ("orbit_frame0", turb, orbit_camera(Camera, 0.0, W, H), "clamp"),
             ("orbit_frame15", turb, orbit_camera(Camera, 2.0 * (N_FRAMES - 1), W, H), "clamp"),
             ("repeat_128", turb, orbit_camera(Camera, 30.0, 128, 128), "repeat"),
             ("adversarial_frame0", adversarial, orbit_camera(Camera, 0.0, W, H), "clamp"),
             ("adversarial_repeat_128", adversarial, orbit_camera(Camera, 30.0, 128, 128),
              "repeat")]
    max_abs_err = 0.0
    for name, v, cam, wrap in cases:
        rays = generate_rays(cam, device=dev)
        Z, Y, X = v.shape
        plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), wrap=wrap)
        vol_u8 = RK.quantize_u8(v)
        args = (plan.entry_uv, plan.dir_step, plan.hit, plan.max_samples, wrap)
        rgb_k, a_k = RK.composite_march_f32_cuda(v, *args, transfer=True)
        rgb_b, a_b = RK.composite_march_cuda(vol_u8, *args, transfer=True)
        c_b, a_b0 = RK.composite_march_cuda(vol_u8, *args)
        c_p, a_p = composite_march_steps(as_normalized_volume(vol_u8), plan.entry_uv,
                                         plan.dir_step, plan.hit.bool(), plan.max_samples, wrap)
        rgb_p = apply_reference_transfer(c_p, a_p)
        torch.cuda.synchronize()
        equal = {"fused_vs_plain": torch.equal(rgb_k, rgb_p) and torch.equal(a_k, a_p),
                 "byte_route_vs_plain": torch.equal(rgb_b, rgb_p) and torch.equal(a_b, a_p),
                 "byte_color_vs_plain": torch.equal(c_b, c_p) and torch.equal(a_b0, a_p),
                 "plan_render_is_fused": all(torch.equal(x, y) for x, y in
                                             zip(plan.render(v), (rgb_k, a_k)))}
        res = compare((rgb_k, a_k), (rgb_p, a_p), cam.width * cam.height)
        if not all(equal.values()):
            raise AssertionError(f"B1 parity {name}: bit-equal {equal}, {res}")
        max_abs_err = max(max_abs_err, res["max_abs_err"])
        emit({"phase": "parity", "case": name, "wrap": wrap, "hw": [cam.height, cam.width],
              "alpha_sum_kernel": float(a_k.sum()), "alpha_sum_plain": float(a_p.sum()),
              "bit_equal": equal, **res})

    # 5. the main path, as a user drives it: camera -> rays -> plan (once per
    # camera) -> render, over the 16-frame orbit; min of REPS sweeps after a
    # warm sweep.  The launch counts cover exactly this run: every render is
    # one launch of the fused B1 and none of the byte route.
    RK.composite_march_f32_cuda.launches = 0
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
    launches = RK.composite_march_f32_cuda.launches
    byte_launches = RK.composite_march_cuda.launches
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

    # per-launch times of the fused B1 (the main path's launch), of B1's
    # byte route (the march the parent frame ran after its quantize) and of
    # the plain version on the orbit's inputs, then each layer of one frame
    # alone (orbit frame 0): the one-launch frame beside the byte route's
    # quantize, march and transfer
    turb_u8 = RK.quantize_u8(turb)
    turb_plain = as_normalized_volume(turb_u8)

    def fused(v, p):
        return RK.composite_march_f32_cuda(v, p.entry_uv, p.dir_step, p.hit, transfer=True)

    kernel_ms = time_ms(lambda: [fused(turb, p) for p in plans]) / N_FRAMES
    byte_ms = time_ms(lambda: [RK.composite_march_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit)
                               for p in plans]) / N_FRAMES
    plain_ms = time_ms(lambda: [composite_march_steps(turb_plain, p.entry_uv, p.dir_step,
                                                      p.hit.bool()) for p in plans]) / N_FRAMES
    emit({"phase": "kernel_timing", "shape": [H, W], "volume": list(VOLUME),
          "frames": N_FRAMES, "kernel_ms_per_launch": kernel_ms,
          "byte_route_march_ms_per_launch": byte_ms, "plain_ms_per_launch": plain_ms,
          "gpu": smi})
    cam0, rays0, plan0 = cameras[0], bundles[0], plans[0]
    c0, a0 = RK.composite_march_cuda(turb_u8, plan0.entry_uv, plan0.dir_step, plan0.hit)

    def byte_route_frame():
        c, a = RK.composite_march_cuda(RK.quantize_u8(turb), plan0.entry_uv, plan0.dir_step,
                                       plan0.hit)
        return RK.apply_reference_transfer(c, a), a

    emit({"phase": "layers", "ms": {
        "generate_rays": time_ms(lambda: generate_rays(cam0, device=dev)),
        "plan": time_ms(lambda: plan_compositing(rays0.entry_uv, rays0.direction, rays0.hit,
                                                 VOLUME[::-1])),
        "frame_one_launch": time_ms(lambda: plan0.render(turb)),
        "byte_route_frame": time_ms(byte_route_frame),
        "byte_route_quantize_u8": time_ms(lambda: RK.quantize_u8(turb)),
        "byte_route_march": time_ms(lambda: RK.composite_march_cuda(
            turb_u8, plan0.entry_uv, plan0.dir_step, plan0.hit)),
        "byte_route_transfer": time_ms(lambda: RK.apply_reference_transfer(c0, a0))},
        "gpu": smi})

    # 6. the main path went through the fused kernel, once per render and
    # never the byte route; under the profiler, one sweep of renders alone
    # (no sums) runs exactly one device kernel per render, B1
    if launches == 0 or launches != renders or byte_launches != 0:
        raise AssertionError(f"fused B1 launched {launches} times for {renders} renders, the "
                             f"byte route {byte_launches} times")
    emit({"phase": "launch_count", "composite_march": launches, "renders": renders,
          "composite_march_byte_route": byte_launches})

    def render_sweep():
        for plan in plans:
            plan.render(turb)

    prof = device_profile(render_sweep)
    events = prof["device_events"]
    if sum(events.values()) != N_FRAMES or not all("composite_march_kernel" in k for k in events):
        raise AssertionError(f"a main-path sweep of {N_FRAMES} renders ran the device work "
                             f"{events}; expected {N_FRAMES} launches of B1 and nothing else")
    emit({"phase": "main_path_profile", "renders": N_FRAMES,
          "device_kernels_per_render": sum(events.values()) / N_FRAMES, **prof, "gpu": smi})

    # B1's bound, per launch over the orbit: the float32 voxels its taps
    # read (a boolean scatter of every sample's 8 tap indices, per frame),
    # the rays read and the image written; the whole volume's bytes beside
    # it.  Frame 0's samples per ray, grouped as the kernel's warps run them
    # (16x2 pixels in its 16x8 blocks; 32x1 in 32x4 blocks, 8x4 in 8x8).
    samples, touched = 0.0, 0.0
    for i, p in enumerate(plans):
        mask = torch.zeros(turb.numel(), dtype=torch.bool, device=dev)
        n = composite_samples(p, turb_plain, touched=mask)
        samples += float(n.sum()) / N_FRAMES
        touched += float(mask.sum()) / N_FRAMES
        if i == 0:
            emit({"phase": "b1_warps", "frame": 0, "samples_per_ray": float(n.mean()),
                  "warps": {f"{h}x{w}": warp_steps(n, (h, w))
                            for h, w in ((2, 16), (1, 32), (4, 8))},
                  "ncu": shutil.which("ncu") or
                  next((str(q) for q in Path("/usr/local/cuda/bin").glob("ncu*")), None)})
    rays_io = sum(nbytes(p.entry_uv, p.dir_step, p.hit) for p in plans) / N_FRAMES
    f32_ops = OPS_PER_STEP["composite_f32"] * samples + TRANSFER_OPS_PER_RAY * W * H
    b1 = {"name": "composite_march", "route": "cuda", "source": KERNEL_SOURCE,
          "replaces": REPLACES, "launches": launches, "max_abs_err": max_abs_err,
          "ms": kernel_ms, "plain_ms": plain_ms,
          **bound(4 * touched + rays_io + RGBA_BYTES * W * H, f32_ops, samples, W * H),
          "volume_route": "float32, each tap quantized as read; rgb written in the epilogue",
          "touched_voxels_per_launch": touched,
          "bound_ms_whole_volume": bound(nbytes(turb) + rays_io + RGBA_BYTES * W * H, f32_ops,
                                         samples, W * H)["bound_ms"],
          "byte_route_march_ms": byte_ms,
          "byte_route_march_bound_ms": bound(touched + rays_io + 8 * W * H,
                                             OPS_PER_STEP["composite"] * samples, samples,
                                             W * H)["bound_ms"]}
    run_routes(dev, smi, turb, plans)

    iso_kernels = run_isosurface(dev, smi, turb, sphere, cameras, bundles)
    grad_kernels = run_gradients(dev, smi, turb, sphere, cameras, bundles, samples, touched,
                                 adversarial)
    pooled_kernels = run_compressed(dev, smi, turb, sphere, cameras, bundles,
                                    {k["name"]: k for k in (b1, *iso_kernels)}, samples)
    sharded_kernels = run_sharded(dev, smi, turb, sphere, cameras, bundles)

    emit({"kernels": [b1, *iso_kernels, *grad_kernels, *pooled_kernels, *sharded_kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
