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
  (kernels ``csrc/iso_march.cu``, skipping exactly and handing each hit's
  near bracket on, and ``csrc/iso_shade.cu`` from that bracket), with the
  bind inside the sweep and outside it (a bind of the unchanged volume
  reuses its grid), and the same unbound, and a bind of new data (a clone)
  timed; the bind's block grid alone (``csrc/block_grid.cu``) against its
  plain version, at 256^3 and at the RM run's 2048x2048x768 bytes;
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
* the compositing bind, over the same orbit on the turbulence, a sphere
  and the turbulence dimmed to 2 %: ``CompositingPlan.bind`` (once per
  data) -> ``render(..., bound=)`` / ``render_pooled(..., bound=)`` (B1, B6
  and B7 skipping the samples of empty blocks exactly); then
  ``make_plan(skip_empty=True)`` against ``skip_empty=False`` in both modes,
  and ``render_isosurface_kernel``'s one-shot bind;
* compressed-domain fine-tuning on orbit frame 0:
  ``CompressedRenderer.diff_decoder`` -> ``make_render_tf_voxel`` (B4, B5)
  -> MSE -> gradients of the tree's Δ map and leaf scalars; and the
  mid-range codec, ``codecs.midrange.build`` -> ``CompressedRenderer``;
* the sharded layouts, over the same orbit, the shards spread round-robin
  over the host's cards: ``make_z_mesh(4)`` / ``make_brick_mesh((2, 2, 1))``
  -> ``shard_volume`` -> ``render_zsharded_kernel`` /
  ``render_bricksharded_kernel`` per frame (the segment march
  ``csrc/seg_march.cu`` B10 once per shard, from each shard's entry table,
  built by that file's table kernel at a camera's first frame and cached on
  its plan), ``tf_fit_step_bricksharded`` x 5 (B11 once per brick), and the
  row-sharded ``render_planned_sharded``,
  ``tf_fit_step_kernel`` and ``voxel_fit_step_kernel`` on ``make_mesh(4)``
  (B1, B4 and B5 once per row shard);
* BASELINE config 4 at 256^3: ``io.bricks.load_bricks`` of 8 synthetic
  128^3 bricks -> ``codecs.hashed.build`` (the native builder
  ``csrc/hashed_build.cu``, host code) -> ``to_device_hashed`` ->
  ``level_cut_device_hashed`` (chunked) -> ``tf_fit_step_fast`` x 5 through
  ``make_render_tf_kernel`` (B4) at 1024^2; the decode against itself on CPU
  tensors (flat and chunked) and, at 64^3, the host ``level_cut``; the
  native builder against the Python one;
* ``codecs.device_build.build_device`` of the 256^3 source on the card,
  equal to the host build, its frame through ``CompressedRenderer`` (B7);
  ``codecs.octree.build`` and its depth-6 cut through the compositing plan
  (B1);
* the application layer: the compressed phase's tree through its
  checkpoint file (``codecs.kdtree.save`` -> ``open_tree_full``, the inverse
  walk in ``csrc/kdtree_native.cu``, host code) and the native
  ``decode_preorder`` and ``build_arbitrary`` (volumes whose sides are not
  powers of two) against their Python versions; ``app.run(AppConfig())`` at
  its defaults in both render modes (the 256^3 turbulence of seed 273, the
  kd-tree at tolerance 6, 1600x1200, each frame one call of the pooled plan:
  B7, or B8 and the pooled shade), a frame under ``utils.timer.timed(...,
  profile=True)``; BASELINE config 5 through ``io.streaming.TimestepStreamer``
  (4 timesteps of 8 synthetic 128^3 bricks, a brick-sharded render, B10,
  and a TF step, B11, per timestep), then resumed from its checkpoints;
* the multi-process layer: two ranks on ``cuda:0`` over gloo
  (``parallel.multihost.spawn`` of ``chip_smoke.py --multihost-rank``, each
  rank ``multihost.initialize`` -> ``host_local_bricks`` /
  ``load_bricks_for_host`` and ``bricks.host_local_bricks_3d``, reading only
  its bricks of config 5's 256^3 volume -> ``global_mesh`` ->
  ``shard_volume(..., offset=)``): ``render_zsharded_kernel`` and
  ``render_bricksharded_kernel`` over the orbit (B10, two launches per rank
  and frame, the segment maps gathered in mesh order),
  ``render_planned_sharded`` (B1) and ``tf_fit_step_kernel`` x 5 (B4) on
  the volume replicated from the z slabs, one ``tf_fit_step_bricksharded``
  step (B11) and ``scaling_probe_kernel``; each output held against this
  process's single-process port on the assembled volume.
* the port's edge: ``entry.entry()`` (the flagship step, one launch of B1
  on the 256^3 sphere at 1024^2); ``scripts/torch_rm_smoke.py`` on 8
  synthetic turbulence bricks of the RM brick size (256x256x128) written in
  the RM layout (discovery, the size check and assembly of the first 8 of a
  row with a CRC32, ``codecs.kdtree.build`` at tolerance 1, one 1024^2
  frame of the 2048x256x128 volume through B1, and its two failure cases);
  ``scripts/torch_render_demo.py`` at its defaults (five PNGs: B1, B2 and
  B3, B7 at two cuts, B1 on the error field), each image held against its
  plain version on the card;
* the port's bench, ``python3 -m volumerenderer_tpu_torch.bench`` in a
  process of its own, as a user runs it: ``bench.py``'s five metrics (B2
  and B3 bound, B6, B7, B4 and B5 against B1, B1), each sweep's sum held
  against the plain versions' on this card, its launch counts, its rates
  beside this run's main paths'.

On the way it builds the kernels from ``volumerenderer_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version and the goldens, times both, and checks that each path launched its
kernels once per render, forward or backward.

Usage, from the root of a checkout:  python3 chip_smoke.py

Each phase prints one JSON line (device, build, goldens, parity, main_path,
kernel_timing, layers, launch_count, main_path_profile, b1_warps,
b1_routes, then iso_goldens, iso_parity,
iso_main_path, iso_timing, iso_layers, iso_launch_count, grid, then tf_parity,
vg_parity, grad_reference, grad_main_path, grad_timing, grad_layers,
vg_tile, grad_launch_count, then codec, decode, pools, pooled_parity,
pooled_main_path, compressed_main_path, pooled_timing, pooled_launch_count,
then composite_bind (one per field), skip_empty, diff_finetune, midrange,
config4, device_build, octree, then sharded_parity, sharded_main_path, sharded_fit, sharded_rows,
sharded_timing, seg_starts, sharded_layers, sharded_launch_count, then checkpoint, app (one per
render mode), config5 and multihost, then entry, rm_smoke and render_demo,
then bench).
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

import dataclasses
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# the iso bind's block grid kernel, and the upstream RM run's byte volume
# (384 bricks of 256x256x128, benchmark/configs/rm384_u8_1600x1200.json)
GRID_SOURCE = "volumerenderer_tpu_torch/csrc/block_grid.cu"
GRID_REPLACES = "none: the JAX bind builds its tables in jnp"
RM_VOLUME = (768, 2048, 2048)
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
# BASELINE config 4 (scripts/run_configs.py:167-224): 8 bricks of a 2x2x2
# grid, timestep 273, the hashed codec at its default tolerance
CONFIG4_BRICK, CONFIG4_TIMESTEP, CONFIG4_TOLERANCE = (128, 128, 128), 273, 4
CONFIG4_TF_RTOL = 2e-3
HASHED_FIELDS = ("distance_map", "tree_data", "tree_structure", "coll_keys", "coll_vals",
                 "coll_data", "coll_structure")
OCTREE_CUTS, OCTREE_RENDER_CUT = (3, 6, 8), 6
# the app and tooling: the checkpoint's native builds on (Z, Y, X) volumes
# whose sides are not powers of two; app.run at its defaults; config 5
CHECKPOINT_SMALL, CHECKPOINT_LARGE, CHECKPOINT_SEED = (12, 20, 24), (96, 160, 192), 7
APP_FRAMES, APP_COMP_BAR, APP_ISO_BAR, PROFILE_WARM_KERNELS = 16, 6e-7, 5e-3, 300
CONFIG5_TIMESTEPS, CONFIG5_BRICK, CONFIG5_TOLERANCE = (270, 271, 272, 273), (128, 128, 128), 4
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
# the multi-process layouts: two ranks on cuda:0 (gloo), each with two
# entries of every mesh, config 5's 2x2x2 grid of 128^3 bricks at timestep 273
MULTIHOST_RANKS, MULTIHOST_TIMESTEP, MULTIHOST_TIMEOUT_S = 2, 273, 300
# the edge of the port (entry(), the RM smoke test and the render demo): 8
# RM-sized bricks (256x256x128) at timestep 273, written in the RM layout and
# loaded as the first 8 of a row; the demo at the JAX script's defaults
RM_BRICKS, RM_TIMESTEP, RM_GRID_TEXT = 8, 273, "8,1,1"
DEMO_SIZE, DEMO_DIMS = 512, (128, 128, 128)
# tests/test_torch_sharded.py's bar for B11 against the single-device fit step
B11_LOSS_RTOL, B11_PARAM_RTOL, B11_PARAM_ATOL = 1e-5, 1e-4, 1e-6
# the port's bench, run as a user runs it: bench.py's five metrics in its
# order, the headline last, and the isovalue PERF.md records for the volume
BENCH_COMMAND = [sys.executable, "-m", "volumerenderer_tpu_torch.bench"]
BENCH_METRICS = ("iso_rays_per_s_per_chip_1024sq_256cube",
                 "pooled_rays_per_s_per_chip_1024sq_256cube",
                 "pooled_pair16_rays_per_s_per_chip_1024sq_256cube",
                 "voxelgrad_step_frames_1024sq_256cube", "rays_per_s_per_chip_1024sq_256cube")
BENCH_ISO, BENCH_TIMEOUT_S, BENCH_AGREEMENT = 0.5411764979362488, 600, 0.15

# The bound of a launch: the larger of its bytes (each input read once, each
# output written once) over the card's memory rate and its float32
# operations over the peak rate outside the tensor cores (NVIDIA's H100 SXM
# data sheet, at 700 W).  Operations per step, from each kernel's arithmetic:
# a trilinear sample 41 (texel coordinates 6, floors 3, fractions 3, byte
# scales 8, seven lerps 21); a position step 3; compositing 6; the TF sums
# 16 more; B1 and B4 on the float32 volume quantize each of the 8 taps
# (max, min, product, round: 4 each), B5 there those of both of its passes'
# samples, and B1 writes 1 - c once per ray; the
# iso crossing test and lookahead step 5; the segment anchor
# test 6 (a segment step before the sample: a position step and the anchor
# test, 9); the voxel gradient's replayed step, cotangent, tap weights and 8
# atomic adds 94 in all; the shade per hit the far end of its bracket 3 (its
# near end comes from the march), 4 bisections (47), 6 normal taps (44) and
# 60 for the Phong terms.  A bound
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
OPS_PER_STEP["voxel_grad_f32"] = OPS_PER_STEP["voxel_grad"] + 2 * 8 * QUANTIZE_OPS_PER_TAP
# bytes per ray: the rays read (entry_uv, dir_step, hit) and B1's displayed
# image written (rgb and alpha)
RAY_BYTES, RGBA_BYTES = 25, 16
TRILINEAR_OPS, ISO_CLASSIFY_OPS = 41, 9
ISO_GATHERED_OPS = OPS_PER_STEP["iso"] + ISO_CLASSIFY_OPS
ISO_SKIPPED_OPS = OPS_PER_STEP["iso"] - TRILINEAR_OPS + ISO_CLASSIFY_OPS
SHADE_OPS_PER_HIT = 3 + 4 * 47 + 6 * 44 + 60
# a bound compositing march (CompositingPlan.bind) classifies every sample's
# block as the bound iso march does: a gathered sample costs its unbound
# step and the classification, a skipped one the position step and it
BIND_CLASSIFY_OPS = ISO_CLASSIFY_OPS
COMP_SKIPPED_OPS = 3 + BIND_CLASSIFY_OPS


# every phase line printed so far, by phase (the bench phase reads the main
# paths' rates from it)
PHASES = {}


def emit(obj) -> None:
    if "phase" in obj:
        PHASES[obj["phase"]] = obj
    print(json.dumps(obj), flush=True)


def import_port():
    """Import the checkout's package, and from its bench the helpers this
    script shares with it: ``orbit_camera(az_deg, width, height)``,
    ``time_ms(fn, reps=3)`` (the card's time by CUDA events) and
    ``nvidia_smi()``."""
    global orbit_camera, time_ms, nvidia_smi
    sys.path.insert(0, str(HERE))
    import volumerenderer_tpu_torch as port

    where = Path(port.__file__).resolve().parent.parent
    if where != HERE:
        raise ImportError(f"volumerenderer_tpu_torch imported from {where}, not {HERE}")
    from volumerenderer_tpu_torch.bench import nvidia_smi, orbit_camera, time_ms
    return port


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
                      pools: tuple = (), cbound=None, skipped: torch.Tensor | None = None):
    """Per-ray samples of the compositing march with its a > 0.99 early-out
    (B1; B4 and B5 at alpha scale ``K``), counted by its plain arithmetic.
    With ``touched`` (a flat bool tensor of the volume's voxels) every voxel
    a sample's taps read is set in it; for each (mask, pool, slab_map) of
    ``pools`` every pool word the pooled march (B6, B7) fetches for those
    samples is set in the mask, a flat bool tensor of the pool's words.
    With a compositing BlockBound ``cbound`` the samples of empty blocks are not
    gathered: they set nothing in the masks, and each is counted in
    ``skipped`` (H, W), if given."""
    from volumerenderer_tpu_torch.ops.raycast import empty_blocks
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
        gather = alive if cbound is None else alive & ~empty_blocks(cbound, pos)
        if skipped is not None:
            skipped += alive & ~gather
        if touched is not None:
            touched[tap_indices(pos[gather], plan.dims)] = True
        for mask, pool, slab_map in pools:
            mask[pool_tap_words(pos[gather], plan.dims, pool, slab_map)] = True
        alive = alive & (alpha <= 0.99)
    return n


def shade_positions(plan, vol_plain, found, near, iso) -> torch.Tensor:
    """The positions (N, 3) at which the shade pass (B3, the pooled shade)
    samples for the hit rays, from the march's ``near``: 4 bisection
    midpoints and 6 normal taps each, from the plain shade's own arithmetic
    through a sampler that records them."""
    from volumerenderer_tpu_torch.ops.isosurface import shade_hits
    from volumerenderer_tpu_torch.ops.sampling import sample_trilinear

    hit, seen = found.bool(), []

    def recording(uvw):
        seen.append(uvw[hit])
        return sample_trilinear(vol_plain, uvw)

    shade_hits(recording, plan.entry_uv, plan.dir_step, plan.direction, found, None, iso,
               near=near)
    return torch.cat(seen)


def shade_ray_bytes(plan, found, near) -> float:
    """The ray bytes a shade launch (B3, the pooled shade) moves from the
    march's ``near``: ``found`` read and rgb (12 B) written for every ray,
    and near, dir_step and direction read for the hit rays alone."""
    per_ray = nbytes(near, plan.dir_step, plan.direction) / found.numel()
    return per_ray * float(found.sum()) + nbytes(found) + 12 * found.numel()


def replayed_near(entry_uv, dir_step, found, t_hit) -> torch.Tensor:
    """Each hit's near bracket replayed in float32: entry_uv plus t_hit + 1
    additions of dir_step, one rounding each (entry_uv for a miss)."""
    n_add = torch.where(found, t_hit.to(torch.int64) + 1, 0)
    near = entry_uv
    for k in range(1, int(n_add.max()) + 1):
        near = torch.where((n_add >= k)[..., None], near + dir_step, near)
    return near


def bits_equal(a, b, mask) -> bool:
    """a and b hold the same float32 bits wherever ``mask`` is set."""
    return bool(torch.equal(a[mask].view(torch.int32), b[mask].view(torch.int32)))


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
    the steps inside the cube + 1 for a miss.  With an iso BlockBound, only those
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
    time / wall; the profiler's own host cost is inside the wall).

    A profiler run that follows GPU work done while nothing was profiled can
    lose the records of its first kernels (torch 2.11 on the H100,
    scripts/torch_profiler_probe.py; once 1 of a main-path sweep's 16), so
    the run first launches PROFILE_WARM_KERNELS spin kernels
    (``torch.cuda._sleep``), which are left out of what it reports."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARM_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, counts = {}, {}
    for e in prof.key_averages():
        # host ops (their kernels are listed apart), the spin kernels and the
        # program's spans (``vr.*`` ranges, listed on the card's timeline too)
        if e.device_type != DeviceType.CUDA or "spin_kernel" in e.key \
                or getattr(e, "is_user_annotation", False):
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
            return RK.composite_march_cuda(RK.quantize_u8(vol), p.entry_uv, p.dir_step, p.hit)

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


def run_isosurface(dev, smi: str, turb, sphere, cameras, bundles, adversarial) -> tuple:
    """The isosurface phases; returns the kernels line's two entries and the
    grid kernel's launches on the main path (one per bind there)."""
    from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
    from volumerenderer_tpu_torch.ops.cuda import blockgrid_kernel as GK
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

    # each kernel vs its plain version on the same inputs, the march with the
    # near bracket and the shade from it (the render route); the shade pass
    # of both is fed the kernel march's hits.  near is held bit-equal on the
    # hit rays to a float32 replay of t_hit + 1 additions and to the plain
    # march's, B3 from near to B3's chain instantiation, bound marches to
    # unbound ones (near too), and the march's (found, t_hit) to the march's
    # without near.  The cases: the earlier slices' and the turbulence made
    # to part a per-tap quantize from quantize_u8 (its bytes here)
    iso_med = IK.volume_median(turb)
    cases = [("entry_sphere", sphere, Camera(width=W, height=H), 0.5, "clamp"),
             ("orbit_frame0", turb, cameras[0], iso_med, "clamp"),
             ("orbit_frame15", turb, cameras[-1], iso_med, "clamp"),
             ("iso40_frame0", turb, cameras[0], 40.0 / 255.0, "clamp"),
             ("repeat_128", turb, orbit_camera(30.0, 128, 128), iso_med, "repeat"),
             ("adversarial_frame0", adversarial, cameras[0], iso_med, "clamp"),
             ("adversarial_repeat_128", adversarial, orbit_camera(30.0, 128, 128),
              iso_med, "repeat")]
    err = {"iso_march": 0.0, "iso_shade": 0.0}
    for name, v, cam, iso, wrap in cases:
        rays = generate_rays(cam, device=dev)
        Z, Y, X = v.shape
        plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), wrap=wrap)
        vol_u8 = quantize_u8(v)
        plain_vol = as_normalized_volume(vol_u8)
        args = (plan.entry_uv, plan.dir_step)
        found_k, t_hit_k, near_k = IK.iso_march_cuda(vol_u8, *args, plan.hit, iso,
                                                     plan.max_samples, wrap, with_near=True)
        found_n, t_hit_n = IK.iso_march_cuda(vol_u8, *args, plan.hit, iso, plan.max_samples,
                                             wrap)
        rgb_k = IK.iso_shade_cuda(vol_u8, *args, plan.direction, found_k, None, iso, wrap,
                                  near_k)
        rgb_c = IK.iso_shade_cuda(vol_u8, *args, plan.direction, found_k, t_hit_k, iso, wrap)
        found_p, t_hit_p, near_p = iso_march_steps(plain_vol, *args, plan.hit.bool(), iso,
                                                   plan.max_samples, wrap, with_near=True)
        rgb_p = shade_hits(plain_vol, *args, plan.direction, found_k, t_hit_k, iso, wrap)
        both = found_k & found_p & (t_hit_k == t_hit_p)
        near_equal = {
            "replay": bits_equal(near_k, replayed_near(*args, found_k, t_hit_k), found_k),
            "plain_march": bits_equal(near_k, near_p, both),
            "march_without_near": bool(torch.equal(found_k, found_n)
                                       and torch.equal(t_hit_k, t_hit_n)),
            "shade_from_near_is_chain": bool(torch.equal(rgb_k, rgb_c))}
        # bound: the kernel and the plain march from the volume's grid, the
        # kernel from its mip8's, each bit-equal to its unbound version
        bounds = {"volume": plan.bind(v, iso), "mip8": plan.bind(v, iso,
                                                                 mip8=RK.block_max8(vol_u8))}
        bound_equal = {}
        for bname, ib in bounds.items():
            fb, tb, nb = IK.iso_march_cuda(vol_u8, *args, plan.hit, iso, plan.max_samples, wrap,
                                           ib, with_near=True)
            bound_equal[f"kernel_{bname}"] = bool(torch.equal(fb, found_k)
                                                  and torch.equal(tb, t_hit_k)
                                                  and bits_equal(nb, near_k, found_k))
        fb, tb = iso_march_steps(plain_vol, plan.entry_uv, plan.dir_step, plan.hit.bool(), iso,
                                 plan.max_samples, wrap, bounds["volume"])
        bound_equal["plain_volume"] = bool(torch.equal(fb, found_p) and torch.equal(tb, t_hit_p))
        torch.cuda.synchronize()
        if not all(bound_equal.values()) or not all(near_equal.values()):
            raise AssertionError(f"iso {name}: a bound march differs from its unbound one "
                                 f"({bound_equal}) or the near route from its replay, the "
                                 f"plain march or the chain ({near_equal})")
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
              "bound_bit_equal": bound_equal, "near_bit_equal": near_equal})

    # the main path: the 16-frame orbit at the volume's median, plans built
    # once per camera and one bound for the volume and isovalue, which every
    # plan shares (bench.py:86 times bound plans); min of REPS sweeps after a
    # warm sweep: bound with the bind outside the sweep (a reused volume and
    # isovalue), with the bind inside it (a new pair each orbit), and
    # unbound; and one frame that pays its own bind (a new pair each frame).
    # The launch counts cover exactly this run: each render one march and
    # one shade; every bind here is of the volume bound above, unchanged, so
    # it reuses that grid (``bind_grid``): no build, no grid kernel.  A bind
    # of new data (a clone) is timed apart, the grid kernel in it.
    plans = [IK.IsosurfacePlan(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]
    iso_bound = plans[0].bind(turb, iso_med)
    IK.iso_march_cuda.launches = 0
    IK.iso_shade_cuda.launches = 0
    GK.iso_block_grid_cuda.launches = 0
    builds, hits = GK.bind_grid.builds, GK.bind_grid.hits
    renders = binds = 0
    last = {}

    def kernel_sweep(mode: str):
        nonlocal renders, binds
        acc = torch.zeros((), device=dev)
        b = {"unbound": None, "bound": iso_bound,
             "bind_in_sweep": plans[0].bind(turb, iso_med) if mode == "bind_in_sweep" else None}
        binds += int(mode == "bind_in_sweep")
        for plan in plans:
            last["rgb"], last["found"] = plan.render(turb, iso_med, bound=b[mode])
            acc = acc + last["rgb"].sum()
            renders += 1
        return float(acc)

    def frame_with_own_bind():
        nonlocal renders, binds
        rgb, _ = plans[0].render(turb, iso_med, bound=plans[0].bind(turb, iso_med))
        renders += 1
        binds += 1
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
    grid_launches = GK.iso_block_grid_cuda.launches
    grid_builds, grid_hits = GK.bind_grid.builds - builds, GK.bind_grid.hits - hits
    plain_sweep_s = sweep_seconds(plain_sweep)
    fresh = iter([turb.clone() for _ in range(REPS + 1)])
    bind_new_data_ms = time_ms(lambda: plans[0].bind(next(fresh), iso_med), reps=REPS)
    del fresh
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
          "bind_ms": time_ms(lambda: plans[0].bind(turb, iso_med)),
          "bind_new_data_ms": bind_new_data_ms, "bound_frame_equal": True,
          "hits_last_frame": int(found.sum()), "frames": N_FRAMES, "reps": REPS, "gpu": smi})

    # per-launch times of each kernel as render launches it (the march with
    # near, the shade from it) and of its plain version over the orbit, the
    # march without near and the shade's chain instantiation beside, then
    # frame 0 split into its layers
    turb_u8 = quantize_u8(turb)
    turb_plain = as_normalized_volume(turb_u8)
    hits = [IK.iso_march_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit, iso_med, with_near=True)
            for p in plans]

    def march_ms(b, with_near=True):
        return time_ms(lambda: [IK.iso_march_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit,
                                                  iso_med, bound=b, with_near=with_near)
                                for p in plans]) / N_FRAMES

    def shade(p, f, t, n):
        return IK.iso_shade_cuda(turb_u8, p.entry_uv, p.dir_step, p.direction, f, t, iso_med,
                                 near=n)

    ms = {"iso_march": march_ms(iso_bound), "iso_march_unbound": march_ms(None),
          "iso_march_without_near": march_ms(iso_bound, False),
          "iso_shade": time_ms(lambda: [shade(p, f, None, n)
                                        for p, (f, _, n) in zip(plans, hits)]) / N_FRAMES,
          "iso_shade_chain": time_ms(lambda: [shade(p, f, t, None)
                                              for p, (f, t, _) in zip(plans, hits)]) / N_FRAMES}
    # the plain marches on frames 0 and 15 (~0.25 s a frame)
    ends = (0, N_FRAMES - 1)
    plain_ms = {
        name: sum(time_ms(lambda: iso_march_steps(turb_plain, plans[i].entry_uv,
                                                  plans[i].dir_step, plans[i].hit.bool(),
                                                  iso_med, bound=b), reps=1)
                  for i in ends) / len(ends)
        for name, b in (("iso_march", iso_bound), ("iso_march_unbound", None))}
    plain_ms["iso_shade"] = time_ms(lambda: [shade_hits(turb_plain, p.entry_uv, p.dir_step,
                                                        p.direction, f, None, iso_med, near=n)
                                             for p, (f, _, n) in zip(plans, hits)]) / N_FRAMES
    # samples per ray the unbound march takes, and those the bound one gathers
    per_ray = {name: sum(float(iso_samples(p, f, t, b).sum())
                         for p, (f, t, _) in zip(plans, hits)) / (N_FRAMES * W * H)
               for name, b in (("samples", None), ("gathered", iso_bound))}
    emit({"phase": "iso_timing", "shape": [H, W], "volume": list(VOLUME), "iso": iso_med,
          "frames": N_FRAMES, "plain_frames": list(ends), "kernel_ms_per_launch": ms,
          "plain_ms_per_launch": plain_ms, "per_ray": per_ray, "gpu": smi})
    rays0, plan0, (f0, t0, n0) = bundles[0], plans[0], hits[0]
    emit({"phase": "iso_layers", "ms": {
        "volume_median": time_ms(lambda: IK.volume_median(turb)),
        "plan": time_ms(lambda: IK.IsosurfacePlan(rays0.entry_uv, rays0.direction, rays0.hit,
                                                  VOLUME[::-1])),
        "quantize_u8": time_ms(lambda: quantize_u8(turb)),
        "bind": time_ms(lambda: plan0.bind(turb, iso_med)),
        "bind_new_data": bind_new_data_ms,
        "march_kernel": time_ms(lambda: IK.iso_march_cuda(turb_u8, plan0.entry_uv,
                                                          plan0.dir_step, plan0.hit, iso_med,
                                                          bound=iso_bound, with_near=True)),
        "march_kernel_unbound": time_ms(lambda: IK.iso_march_cuda(
            turb_u8, plan0.entry_uv, plan0.dir_step, plan0.hit, iso_med, with_near=True)),
        "shade_kernel": time_ms(lambda: shade(plan0, f0, None, n0)),
        "shade_kernel_chain": time_ms(lambda: shade(plan0, f0, t0, None))},
        "hits_frame0": int(f0.sum()), "gpu": smi})

    # the main path went through both kernels, once per render each, and
    # every bind of its unchanged volume reused the grid: no build, no grid
    # kernel, never the plain reductions
    if renders == 0 or any(n != renders for n in launches.values()):
        raise AssertionError(f"isosurface kernels launched {launches} times for {renders} "
                             f"renders")
    if binds == 0 or grid_launches != grid_builds or grid_builds != 0 or grid_hits != binds:
        raise AssertionError(f"{binds} binds of an unchanged volume built {grid_builds} grids "
                             f"({grid_launches} grid kernels) and reused {grid_hits}")
    emit({"phase": "iso_launch_count", **launches, "renders": renders,
          "block_grid": grid_launches, "binds": binds, "grid_builds": grid_builds,
          "grid_hits": grid_hits})

    # the bounds, per launch over the orbit: a hit samples at steps 0..t_hit
    # and once before, a miss once per step inside the cube and once before;
    # the march writes near (12 B) for each hit, the shade reads it
    samples, shade_ops = 0.0, 0.0
    io = {"iso_march": 0, "iso_shade": 0, "iso_shade_every_ray": 0}
    for p, (f, t, n) in zip(plans, hits):
        found = f.bool()
        steps = torch.where(found, t.float() + 2.0, march_steps(p) + 1.0) * p.hit
        samples += float(steps.sum())
        shade_ops += SHADE_OPS_PER_HIT * float(found.sum())
        io["iso_march"] += nbytes(turb_u8, p.entry_uv, p.dir_step, p.hit, f, t) \
            + 12 * float(found.sum())
        io["iso_shade"] += shade_ray_bytes(p, f, n)
        io["iso_shade_every_ray"] += nbytes(n, p.dir_step, p.direction, f) + 12 * W * H
    # the shade's bytes of the volume: the voxels its taps read, per frame (a
    # boolean scatter of every shade sample's 8 tap indices), as B1's bound
    # counts its voxels; the whole volume's bytes beside it, and the count
    # that reads every ray's inputs (not only the hit rays') beside that
    touched = torch.zeros(turb_u8.numel(), dtype=torch.bool, device=dev)
    shade_voxels = 0.0
    for p, (f, _, n) in zip(plans, hits):
        touched.zero_()
        touched[tap_indices(shade_positions(p, turb_plain, f, n, iso_med), p.dims)] = True
        shade_voxels += float(touched.sum()) / N_FRAMES
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
            "iso_shade": bound(io["iso_shade"] / N_FRAMES + shade_voxels, shade_ops / N_FRAMES,
                               10.0 * sum(float(f.sum()) for f, _, _ in hits) / N_FRAMES, W * H)}
    extra = {"iso_march": {"gathered_per_ray": per_ray["gathered"],
                           "bound_ms_unskipped_formula": unskipped["bound_ms"],
                           "ops_unskipped_formula": unskipped["ops"],
                           "ms_unbound": ms["iso_march_unbound"],
                           "ms_without_near": ms["iso_march_without_near"],
                           "plain_ms_unbound": plain_ms["iso_march_unbound"]},
             "iso_shade": {"touched_voxels_per_launch": shade_voxels,
                           "ms_chain": ms["iso_shade_chain"],
                           "bound_ms_whole_volume": bound(
                               (io["iso_shade"] + N_FRAMES * nbytes(turb_u8)) / N_FRAMES,
                               shade_ops / N_FRAMES, 1.0, W * H)["bound_ms"],
                           "bound_ms_every_ray_read": bound(
                               io["iso_shade_every_ray"] / N_FRAMES + shade_voxels,
                               shade_ops / N_FRAMES, 1.0, W * H)["bound_ms"]}}
    return [{"name": name, "route": "cuda", "source": ISO_SOURCES[name],
             "replaces": ISO_REPLACES[name], "launches": launches[name],
             "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
             **roof[name], **extra[name]}
            for name in ("iso_march", "iso_shade")], grid_launches


def run_grid(dev, smi: str, turb, main_path_launches: int) -> dict:
    """The iso bind's block grid: ``iso_block_grid_cuda`` (``csrc/block_grid.cu``)
    against the plain ``iso_block_grid`` on the card, bit for bit in both
    wraps, on the smoke's 256^3 turbulence (float32, as the iso phases bind
    it, and its bytes) and on a 2048x2048x768 byte volume (3.22 GB, the
    upstream RM run's size; a ramp made on the card, since the time depends
    on the size alone); each timed as a bind runs it, min of REPS after a
    warm call (the 256^3 volumes lie in L2 from the call before).  The
    bound: the volume read and the grid written once over the card's memory
    rate.  Returns the kernels line's entry, at the RM size, with the
    launches of the iso main path's binds (``main_path_launches``: 0, as
    they bind a volume bound before and reuse its grid; a build is 1 per
    bind of new data); this phase's own calls are counted apart."""
    from volumerenderer_tpu_torch.ops.blockgrid import iso_block_grid
    from volumerenderer_tpu_torch.ops.cuda import blockgrid_kernel as GK
    from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import quantize_u8

    def axis(n, k):
        return (torch.arange(n, device=dev) * k % 256).to(torch.uint8)

    rm = axis(RM_VOLUME[0], 5)[:, None, None] + axis(RM_VOLUME[1], 3)[None, :, None] \
        + axis(RM_VOLUME[2], 2)
    GK.iso_block_grid_cuda.launches = 0
    out = {}
    for name, vol in (("turb_256_f32", turb), ("turb_256_u8", quantize_u8(turb)),
                      ("rm_2048x2048x768_u8", rm)):
        for wrap in ("clamp", "repeat"):
            if not torch.equal(GK.iso_block_grid_cuda(vol, wrap), iso_block_grid(vol, wrap)):
                raise AssertionError(f"grid {name}, {wrap}: the kernel's grid differs from the "
                                     f"plain version's")
        grid_bytes = nbytes(GK.iso_block_grid_cuda(vol))
        ms = time_ms(lambda: GK.iso_block_grid_cuda(vol))
        bound_ms = 1e3 * (nbytes(vol) + grid_bytes) / HBM_BYTES_PER_S
        out[name] = {"shape": list(vol.shape), "dtype": str(vol.dtype)[6:], "ms": ms,
                     "plain_ms": time_ms(lambda: iso_block_grid(vol)), "bound_ms": bound_ms,
                     "share_of_bound": bound_ms / ms, "bytes": nbytes(vol) + grid_bytes}
    launches = GK.iso_block_grid_cuda.launches
    del rm
    torch.cuda.empty_cache()
    emit({"phase": "grid", "ms": out, "grid_phase_launches": launches, "bit_equal": True,
          "gpu": smi})
    main = out["rm_2048x2048x768_u8"]
    return {"name": "block_grid", "route": "cuda", "source": GRID_SOURCE,
            "replaces": GRID_REPLACES, "launches": main_path_launches,
            "grid_phase_launches": launches, "max_abs_err": 0.0,
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "bytes": main["bytes"], "ops": 0.0,
            "share_of_bound": main["share_of_bound"],
            "turb_256": {k: out[k] for k in ("turb_256_f32", "turb_256_u8")}}


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
            k = TK.tf_march_cuda(v, plan.entry_uv, plan.dir_step, plan.hit, tf)
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
                rgb1, a1 = RK.composite_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit)
                line["color_alpha_equal_b1"] = bool(
                    torch.equal(rgb1, RK.apply_reference_transfer(k[0], k[1]))
                    and torch.equal(a1, k[1]))
                if not line["color_alpha_equal_b1"]:
                    raise AssertionError(f"tf {name}: at reference params B4's color/alpha "
                                         f"differ from B1's")
            emit(line)
            if not name.startswith("adversarial"):  # B5 is held on the earlier cases
                vg_inputs.append((name, pname, params, plan, v, vol_u8, plain_vol, k))

    # B5 vs its plain version on the same cases, seeded cotangents, fed B4's
    # alpha_T and P_total, on both of its routes: the float32 volume (the
    # main path's, each tap quantized as read) and quantize_u8 of it; and
    # the conservation check: the 8 trilinear weights sum to 1, so
    # sum(g_vol) = sum of every alive step's g_s.  The routes' taps are
    # bit-equal, so their blocks' counters are too
    for i, (name, pname, params, plan, v, vol_u8, plain_vol, k) in enumerate(vg_inputs):
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        g_rgb = torch.randn((H, W, 3), generator=gen, device=dev)
        g_alpha = torch.randn((H, W), generator=gen, device=dev)
        tf = CF.tf_scalars(params)
        gc, gaT_term = CF.cotangent_images(params, g_rgb, g_alpha, k[1])
        args = (plan.entry_uv, plan.dir_step)
        g_k = {"f32": VK.voxel_grad_cuda(v, *args, plan.hit, tf, gc, gaT_term, k[3]),
               "byte": VK.voxel_grad_cuda(vol_u8, *args, plan.hit, tf, gc, gaT_term, k[3])}
        blocks = {route: VK.voxel_grad_block_stats(vol, *args, plan.hit, tf, gc, gaT_term,
                                                   k[3])[1]
                  for route, vol in (("f32", v), ("byte", vol_u8))}
        if blocks["f32"] != blocks["byte"]:
            raise AssertionError(f"voxel_grad {name} {pname}: the float32 route's blocks "
                                 f"{blocks['f32']} differ from the byte route's "
                                 f"{blocks['byte']}")
        g_p = CF.voxel_grad_steps(plain_vol, *args, plan.hit.bool(), tf, gc, gaT_term, k[3])
        gs_sum = gs_abs = 0.0
        for _, g_s in CF.step_cotangents(plain_vol, *args, plan.hit.bool(), tf, gc, gaT_term,
                                         k[3]):
            gs_sum += float(g_s.double().sum())
            gs_abs += float(g_s.double().abs().sum())
        torch.cuda.synchronize()
        scale = float(g_p.abs().max())
        max_abs = {r: float((g - g_p).abs().max()) for r, g in g_k.items()}
        rel = {r: m / scale for r, m in max_abs.items()}
        conservation = {r: abs(float(g.double().sum()) - gs_sum) / gs_abs
                        for r, g in g_k.items()}
        for r in g_k:
            if not rel[r] <= VG_REL or not conservation[r] <= VG_CONSERVATION:
                raise AssertionError(f"voxel_grad {name} {pname} ({r} route): max |d| / "
                                     f"max |g| {rel[r]} (bar {VG_REL}), conservation "
                                     f"{conservation[r]} (bar {VG_CONSERVATION})")
        err["voxel_grad"] = max(err["voxel_grad"], max_abs["f32"])
        emit({"phase": "vg_parity", "case": name, "params": pname, "max_abs_err": max_abs["f32"],
              "max_abs_g_plain": scale, "rel_err": rel["f32"], "bar": VG_REL,
              "sum_g_vol_kernel": float(g_k["f32"].double().sum()), "sum_alive_g_s": gs_sum,
              "sum_abs_alive_g_s": gs_abs, "conservation_rel": conservation["f32"],
              "byte_route": {"max_abs_err": max_abs["byte"], "rel_err": rel["byte"],
                             "conservation_rel": conservation["byte"]},
              "blocks_equal_byte_route": True, "blocks": blocks["f32"]})
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
    TK.tf_march_cuda.launches = TK.tf_march_cuda.f32_launches = 0
    VK.voxel_grad_cuda.launches = VK.voxel_grad_cuda.f32_launches = 0
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
    launches = {"tf_march": TK.tf_march_cuda.f32_launches,
                "voxel_grad": VK.voxel_grad_cuda.launches}
    tf_byte_launches = TK.tf_march_cuda.launches - TK.tf_march_cuda.f32_launches
    vg_f32_launches = VK.voxel_grad_cuda.f32_launches
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
        "tf_march": time_ms(lambda: [TK.tf_march_cuda(turb, p.entry_uv, p.dir_step, p.hit, tf)
                                     for p in plans]) / N_FRAMES,
        "tf_march_byte_route": time_ms(lambda: [
            TK.tf_march_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit, tf)
            for p in plans]) / N_FRAMES,
        "voxel_grad": time_ms(lambda: [VK.voxel_grad_cuda(turb, p.entry_uv, p.dir_step, p.hit,
                                                          tf, *c)
                                       for p, c in zip(plans, cots)]) / N_FRAMES,
        "voxel_grad_byte_route": time_ms(lambda: [
            VK.voxel_grad_cuda(turb_u8, p.entry_uv, p.dir_step, p.hit, tf, *c)
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
    # kernel alone runs into a buffer filled once, outside the timing, on the
    # float32 volume as the step runs it (its byte route and the quantize
    # pass that route would need beside, outside the sum)
    k0 = TK.tf_march_cuda(turb_u8, plan0.entry_uv, plan0.dir_step, plan0.hit, tf)
    rgb0 = (reference.flip_sign * k0[0][..., None] + reference.flip_bias).requires_grad_(True)
    (g_rgb0,) = torch.autograd.grad(torch.mean((rgb0 - target) ** 2), [rgb0])
    gc0, gaT0 = CF.cotangent_images(reference, g_rgb0, None, k0[1])
    g_buf = torch.zeros(turb.shape, dtype=torch.float32, device=dev)
    Z, Y, X = turb.shape

    def b5_alone(volume):
        entry = _launch.dense_entry("voxel_grad", volume)
        _launch.launch(lambda: VK._launcher(entry), "voxel_grad", dev,
                       plan0.entry_uv.data_ptr(), plan0.dir_step.data_ptr(),
                       plan0.hit.data_ptr(), volume.data_ptr(), tf.data_ptr(), gc0.data_ptr(),
                       gaT0.data_ptr(), k0[3].data_ptr(), H, W, X, Y, Z, plan0.max_samples,
                       g_buf.data_ptr(), None)

    def loss_and_cotangent():
        rgb = (reference.flip_sign * k0[0][..., None] + reference.flip_bias).requires_grad_(True)
        return torch.autograd.grad(torch.mean((rgb - target) ** 2), [rgb])

    def sgd_update():
        return ([p - FIT_LR * g for p, g in zip(reference, gp)], turb - FIT_LR * gv)

    layers = {
        "quantize_u8": time_ms(lambda: RK.quantize_u8(turb)),
        "tf_march_kernel": time_ms(lambda: TK.tf_march_cuda(turb, plan0.entry_uv,
                                                            plan0.dir_step, plan0.hit, tf)),
        "tf_march_kernel_byte_route": time_ms(lambda: TK.tf_march_cuda(
            turb_u8, plan0.entry_uv, plan0.dir_step, plan0.hit, tf)),
        "transfer_loss_and_cotangent": time_ms(loss_and_cotangent),
        "cotangent_images": time_ms(lambda: CF.cotangent_images(reference, g_rgb0, None, k0[1])),
        "param_grad_reductions": time_ms(lambda: CF.tf_param_grads(reference, k0, g_rgb0, gc0,
                                                                   gaT0)),
        "zero_fill": time_ms(lambda: torch.zeros(turb.shape, dtype=torch.float32, device=dev)),
        "voxel_grad_kernel": time_ms(lambda: b5_alone(turb)),
        "voxel_grad_kernel_byte_route": time_ms(lambda: b5_alone(turb_u8)),
        "sgd_update": time_ms(sgd_update),
        "whole_step_events": time_ms(grad_step)}
    tf_fit_step_ms = time_ms(lambda: TK.tf_fit_step_fast(f_tf, reference, turb, target,
                                                         lr=FIT_LR))
    emit({"phase": "grad_layers", "ms": layers,
          "sum_of_layers": sum(v for n, v in layers.items()
                               if n not in ("whole_step_events", "tf_march_kernel_byte_route",
                                            "voxel_grad_kernel_byte_route", "quantize_u8")),
          "tf_fit_step_events_ms": tf_fit_step_ms, "gpu": smi})

    # B5's blocks: how many accumulated in their shared tile and how many
    # added to device memory, the launch's global atomicAdds (and the 8 per
    # alive step a launch without the tile would make) and the blocks'
    # boxes, on orbit frames 0 and 15 (the main path's cotangents), and on
    # frame 0 of a volume dimmed to 25 % and to 2 %, whose deeper rays
    # overflow the tile; on the float32 volume as the main path runs it,
    # its counters held equal to the byte route's on quantize_u8 of it
    for name, vol, vol_u8, plan, c in (
            ("orbit_frame0", turb, turb_u8, plans[0], cots[0]),
            ("orbit_frame15", turb, turb_u8, plans[-1], cots[-1]),
            ("dim25_frame0", turb * 0.25, None, plans[0], None),
            ("dim2_frame0", turb * 0.02, None, plans[0], None)):
        if vol_u8 is None:
            vol_u8 = RK.quantize_u8(vol)
        if c is None:  # the dimmed volume's own forward and cotangents
            kd = TK.tf_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit, tf)
            rgb_d = reference.flip_sign * kd[0][..., None] + reference.flip_bias
            c = (*CF.cotangent_images(reference, (rgb_d - target) * (2.0 / rgb_d.numel()), None,
                                      kd[1]), kd[3])
        rest = (plan.entry_uv, plan.dir_step, plan.hit, tf, *c)
        g_k, stats = VK.voxel_grad_block_stats(vol, *rest)
        byte_stats = VK.voxel_grad_block_stats(vol_u8, *rest)[1]
        if stats != byte_stats:
            raise AssertionError(f"voxel_grad {name}: the float32 route's blocks {stats} differ "
                                 f"from the byte route's {byte_stats}")
        # the kernel alone (no zero fill), on each route
        names = ("entry_uv", "dir_step", "hit", "tf_scalars", "gc", "gaT_term", "P_tot")
        tensors = {"volume": vol, **dict(zip(names, rest))}
        ms_case = time_ms(lambda: VK._launch_vg(tensors, plan.max_samples, g_buf, None))
        byte_tensors = {**tensors, "volume": vol_u8}
        ms_byte = time_ms(lambda: VK._launch_vg(byte_tensors, plan.max_samples, g_buf, None))
        g_p = CF.voxel_grad_steps(as_normalized_volume(vol_u8), plan.entry_uv, plan.dir_step,
                                  plan.hit.bool(), tf, *c)
        torch.cuda.synchronize()
        rel = float((g_k - g_p).abs().max()) / float(g_p.abs().max())
        if not rel <= VG_REL:
            raise AssertionError(f"voxel_grad {name} with its block counters: max |d| / max |g| "
                                 f"{rel} (bar {VG_REL})")
        emit({"phase": "vg_tile", "case": name, **stats, "kernel_ms": ms_case,
              "byte_route_kernel_ms": ms_byte, "blocks_equal_byte_route": True, "rel_err": rel,
              "gpu": smi})

    # the main path went through both kernels: B4 once per forward, B5 once
    # per backward, both on the float32 volume
    if launches["tf_march"] != runs["forwards"] or launches["voxel_grad"] != runs["backwards"] \
            or not runs["forwards"] or not runs["backwards"] or tf_byte_launches \
            or vg_f32_launches != runs["backwards"]:
        raise AssertionError(f"gradient kernels launched {launches} times for {runs}, B4's "
                             f"byte route {tf_byte_launches} times, B5's float32 route "
                             f"{vg_f32_launches} times")
    emit({"phase": "grad_launch_count", **launches, **runs,
          "tf_march_byte_route": tf_byte_launches, "voxel_grad_f32_route": vg_f32_launches})
    # B4's bound as B1's: the float32 voxels its taps read (B1's at
    # reference params), the rays, the TF scalars and the seven planes
    rays_io = sum(nbytes(p.entry_uv, p.dir_step, p.hit) for p in plans) / N_FRAMES
    tf_io = nbytes(tf) + rays_io + 7 * 4 * W * H
    tf_ops = OPS_PER_STEP["tf_f32"] * samples
    # B5's the same way, with the cotangent planes read and the gradient
    # written whole (its zero fill, in the wrapper's time)
    vg_io = nbytes(tf, *cots[0]) + rays_io + 4 * turb.numel()
    vg_ops = OPS_PER_STEP["voxel_grad_f32"] * samples
    bounds = {"tf_march": {**bound(4 * touched + tf_io, tf_ops, samples, W * H),
                           "volume_route": "float32, each tap quantized as read",
                           "bound_ms_whole_volume": bound(nbytes(turb) + tf_io, tf_ops, samples,
                                                          W * H)["bound_ms"],
                           "byte_route_ms": ms["tf_march_byte_route"],
                           "byte_route_bound_ms": bound(touched + tf_io,
                                                        OPS_PER_STEP["tf"] * samples, samples,
                                                        W * H)["bound_ms"]},
              "voxel_grad": {**bound(4 * touched + vg_io, vg_ops, samples, W * H),
                             "volume_route": "float32, each tap quantized as read",
                             "bound_ms_whole_volume": bound(nbytes(turb) + vg_io, vg_ops,
                                                            samples, W * H)["bound_ms"],
                             "byte_route_ms": ms["voxel_grad_byte_route"],
                             "byte_route_bound_ms": bound(touched + vg_io,
                                                          OPS_PER_STEP["voxel_grad"] * samples,
                                                          samples, W * H)["bound_ms"]}}
    return [{"name": name, "route": "cuda", "source": GRAD_SOURCES[name],
             "replaces": GRAD_REPLACES[name], "launches": launches[name],
             "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
             **bounds[name]}
            for name in ("tf_march", "voxel_grad")]


def run_compressed(dev, smi: str, turb, sphere, cameras, bundles, dense: dict,
                   samples: float) -> list:
    """The compressed-domain phases; returns the kernels line's five entries,
    the tree, the volume it was built from and the tree's build seconds.
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
    # the plain marches; the shade fed the kernel's hits) and vs its dense
    # kernel, bit for bit, on the same u8 volume: orbit frames 0 and 15 on
    # the turbulence, the default camera on the sphere (mostly slot-0 reads).  B6 and B7 with the
    # transfer in their epilogue (render_pooled's launch) equal
    # apply_reference_transfer of their color and the fused dense B1 on the
    # float32 volume, bit for bit.  B8 and B9 return near (render_pooled's
    # launch), bit-equal on the hit rays to B2's and to the plain march's;
    # the pooled shade from it equals its chain instantiation and B3 from
    # near.
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
        rgb_b1, a_b1 = RK.composite_march_cuda(vol_u8, *args, plan.hit)
        rgb_f, a_f = RK.composite_march_cuda({"turbulence": turb, "sphere": sphere}[vname],
                                             *args, plan.hit)
        f_d, t_d, n_d = IK.iso_march_cuda(vol_u8, *args, plan.hit, iso, with_near=True)
        dense_grid = plan.bind(vol_u8, iso).grid
        for fmt, (comp, isom) in marches.items():
            pool, smap = pools[vname, fmt]
            sampler = slab_pool_sampler(pool, smap, VOLUME[::-1])
            rgb_e, a_e = comp(pool, smap, *args, plan.hit)
            f_k, t_k, n_k = isom(pool, smap, *args, plan.hit, iso, with_near=True)
            # bound from the pool's own bytes (the grid of the volume it was
            # built from) and from the volume's mip8
            iso_bounds = {"pool": plan.bind(iso_value=iso, pool=(pool, smap)),
                          "mip8": plan.bind(iso_value=iso, pool=(pool, smap),
                                            mip8=RK.block_max8(vol_u8))}
            bound_equal = {"pool_grid_is_volume_grid": bool(torch.equal(iso_bounds["pool"].grid,
                                                                        dense_grid))}
            for bname, ib in iso_bounds.items():
                f_b, t_b, n_b = isom(pool, smap, *args, plan.hit, iso, bound=ib, with_near=True)
                bound_equal[bname] = bool(torch.equal(f_b, f_k) and torch.equal(t_b, t_k)
                                          and bits_equal(n_b, n_k, f_k))
            f_n, t_n = isom(pool, smap, *args, plan.hit, iso)
            rgb_k = IK.iso_shade_pooled_cuda(pool, smap, *args, plan.direction, f_k, None, iso,
                                             near=n_k)
            rgb_kc = IK.iso_shade_pooled_cuda(pool, smap, *args, plan.direction, f_k, t_k, iso)
            rgb_d = IK.iso_shade_cuda(vol_u8, *args, plan.direction, f_k, None, iso, near=n_k)
            rgb_dc = IK.iso_shade_cuda(vol_u8, *args, plan.direction, f_k, t_k, iso)
            c_p, a_p = composite_march_steps(sampler, *args, plan.hit.bool())
            rgb_p = apply_reference_transfer(c_p, a_p)
            f_p, t_p, n_p = iso_march_steps(sampler, *args, plan.hit.bool(), iso, with_near=True)
            shade_p = shade_hits(sampler, *args, plan.direction, f_k, t_k, iso)
            torch.cuda.synchronize()
            dense_equal = bool(torch.equal(rgb_e, rgb_b1) and torch.equal(a_e, a_b1)
                               and torch.equal(f_k, f_d) and torch.equal(t_k, t_d)
                               and bits_equal(n_k, n_d, f_k) and torch.equal(rgb_k, rgb_d)
                               and torch.equal(rgb_k, rgb_dc) and torch.equal(rgb_k, rgb_kc)
                               and torch.equal(f_n, f_k) and torch.equal(t_n, t_k))
            epilogue_equal = bool(torch.equal(rgb_e, rgb_f) and torch.equal(a_e, a_f))
            plain_equal = {name: bool(torch.equal(k, q)) for name, k, q in (
                ("rgb", rgb_e, rgb_p), ("alpha", a_e, a_p), ("found", f_k, f_p),
                ("t_hit", t_k, t_p), ("shade", rgb_k, shade_p))}
            plain_equal["near"] = bits_equal(n_k, n_p, f_k & f_p & (t_k == t_p))
            res = compare((rgb_e, a_e), (rgb_p, a_p), W * H)
            px_differ = int(((f_k != f_p) | (t_k != t_p)).sum())
            t_err = float((t_k - t_p).abs().max())
            rgb_err = float((rgb_k - shade_p).abs().max())
            if not dense_equal or not epilogue_equal or not all(bound_equal.values()) \
                    or not all(plain_equal.values()) \
                    or px_differ > res["px_allowed"] or rgb_err > ISO_RGB_TOL:
                raise AssertionError(f"pooled {case} {fmt}: equal to the dense kernels "
                                     f"{dense_equal}; bit-equal to the plain versions "
                                     f"{plain_equal}; the epilogue's image equal to the "
                                     f"fused dense B1's {epilogue_equal}; "
                                     f"bound equal to unbound {bound_equal}; "
                                     f"vs plain {px_differ} px differ in found/t_hit (allowed "
                                     f"{res['px_allowed']:g}), rgb max |d| {rgb_err} (bar "
                                     f"{ISO_RGB_TOL})")
            err[f"composite_march_pooled_{fmt}"] = max(err[f"composite_march_pooled_{fmt}"],
                                                      res["max_abs_err"])
            err[f"iso_march_pooled_{fmt}"] = max(err[f"iso_march_pooled_{fmt}"], t_err)
            err["iso_shade_pooled"] = max(err["iso_shade_pooled"], rgb_err)
            emit({"phase": "pooled_parity", "case": case, "pool": fmt, "iso": iso,
                  "equal_to_dense_kernels": dense_equal, "bit_equal_to_plain": plain_equal,
                  "epilogue_equal_to_fused_b1": epilogue_equal, **res,
                  "iso_px_differ_found_t_hit": px_differ, "t_hit_max_abs_err": t_err,
                  "rgb_max_abs_err": rgb_err, "hits_kernel": int(f_k.sum()),
                  "alpha_sum_kernel": float(a_e.sum()), "bound_bit_equal": bound_equal})
            if case != "entry_sphere":
                plain_inputs.append((fmt, sampler, plan, f_k, n_k))

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
                                            iso_med, with_near=True) for p in iplans]

    def per_frame(fn, plans):
        return time_ms(lambda: [fn(p) for p in plans]) / len(plans)

    # B6 and B7 as render_pooled launches them (the transfer in the epilogue)
    ms = {
        "composite_march_pooled_narrow": per_frame(
            lambda p: RK.composite_march_pooled_narrow_cuda(pool_n, smap_n, p.entry_uv,
                                                            p.dir_step, p.hit), cplans),
        "composite_march_pooled_pair16": per_frame(
            lambda p: RK.composite_march_pooled_pair16_cuda(pool_16, smap_16, p.entry_uv,
                                                            p.dir_step, p.hit), cplans),
        "iso_march_pooled_narrow": per_frame(
            lambda p: IK.iso_march_pooled_narrow_cuda(pool_n, smap_n, p.entry_uv, p.dir_step,
                                                      p.hit, iso_med, with_near=True), iplans),
        "iso_march_pooled_pair16": per_frame(
            lambda p: IK.iso_march_pooled_pair16_cuda(pool_16, smap_16, p.entry_uv,
                                                      p.dir_step, p.hit, iso_med,
                                                      with_near=True), iplans)}
    # the pooled shade from near (render_pooled's launch) on each pool, and
    # its chain instantiation beside
    shade_ms = {f"{fmt}{route}": time_ms(lambda: [
        IK.iso_shade_pooled_cuda(pool, smap, p.entry_uv, p.dir_step, p.direction, f,
                                 None if route == "" else t, iso_med,
                                 near=n if route == "" else None)
        for p, (f, t, n) in zip(iplans, hits)]) / N_FRAMES
        for fmt, (pool, smap) in (("narrow", (pool_n, smap_n)), ("pair16", (pool_16, smap_16)))
        for route in ("", "_chain")}
    ms["iso_shade_pooled"] = shade_ms["narrow"]
    # B8 and B9 bound from their pool's grid (B2's grid and positions, so
    # B2's gathers)
    bound_ms = {
        f"iso_march_pooled_{fmt}": time_ms(
            lambda: [march(pool, smap, p.entry_uv, p.dir_step, p.hit, iso_med,
                           bound=pbounds[fmt], with_near=True) for p in iplans]) / N_FRAMES
        for fmt, march, (pool, smap) in (
            ("narrow", IK.iso_march_pooled_narrow_cuda, (pool_n, smap_n)),
            ("pair16", IK.iso_march_pooled_pair16_cuda, (pool_16, smap_16)))}
    plain_ms = dict.fromkeys(names, 0.0)
    for fmt, sampler, plan, f_k, n_k in plain_inputs:
        args = (plan.entry_uv, plan.dir_step)
        plain_ms[f"composite_march_pooled_{fmt}"] += time_ms(
            lambda: composite_march_steps(sampler, *args, plan.hit.bool()), reps=1) / 2
        plain_ms[f"iso_march_pooled_{fmt}"] += time_ms(
            lambda: iso_march_steps(sampler, *args, plan.hit.bool(), iso_med), reps=1) / 2
        if fmt == "narrow":
            plain_ms["iso_shade_pooled"] += time_ms(
                lambda: shade_hits(sampler, *args, plan.direction, f_k, None, iso_med,
                                   near=n_k), reps=1) / 2
    emit({"phase": "pooled_timing", "shape": [H, W], "volume": list(VOLUME), "iso": iso_med,
          "frames": N_FRAMES, "plain_frames": [0, N_FRAMES - 1],
          "kernel_ms_per_launch": ms, "bound_kernel_ms_per_launch": bound_ms,
          "shade_ms_per_launch": shade_ms, "plain_ms_per_launch": plain_ms,
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
    # found and t_hit written for every ray, near for the hit rays
    hit_io = sum(nbytes(f, t) + 12 * float(f.sum()) for f, t, _ in hits) / N_FRAMES

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
                                                  W * H)["bound_ms"]}
    bounds.update({f"iso_march_pooled_{fmt}": bound(pool_io[fmt] + rays_io + hit_io,
                                                    iso["ops_unskipped_formula"],
                                                    iso["samples_per_ray"] * W * H, W * H)
                   for fmt in pool_io})
    # the pooled shade on the narrow pool: the pool words its taps fetch per
    # frame (its sample positions are B3's, bit for bit) and the ray bytes of
    # the hit rays, as B3's bound; the whole pool's bytes beside, and the
    # count that reads every ray's inputs beside that
    shade_rest = sum(shade_ray_bytes(p, f, n) for p, (f, _, n) in zip(iplans, hits)) / N_FRAMES
    shade_words = 0.0
    for p, (f, _, n) in zip(iplans, hits):
        mask = torch.zeros(pool_n.numel(), dtype=torch.bool, device=dev)
        mask[pool_tap_words(shade_positions(p, turb_plain, f, n, iso_med), p.dims, pool_n,
                            smap_n)] = True
        shade_words += float(mask.sum()) / N_FRAMES
    shade_pool = shade_words * pool_n.element_size() + nbytes(smap_n)
    every_ray = sum(nbytes(n, p.dir_step, p.direction, f)
                    for p, (f, _, n) in zip(iplans, hits)) / N_FRAMES + 12 * W * H
    bounds["iso_shade_pooled"] = {
        **like(shade, shade_pool + shade_rest),
        "touched_pool_words_per_launch": shade_words,
        "bound_ms_whole_pool": like(shade, pool_io["narrow"] + shade_rest)["bound_ms"],
        "bound_ms_every_ray_read": like(shade, shade_pool + every_ray)["bound_ms"],
        "ms_pair16": shade_ms["pair16"], "ms_chain": shade_ms["narrow_chain"],
        "ms_pair16_chain": shade_ms["pair16_chain"]}
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
             "ms": ms[n], "plain_ms": plain_ms[n], **bounds[n]} for n in names], tree, source, \
        build_s


def run_composite_bind(dev, smi: str, turb, sphere, bundles) -> list:
    """``CompositingPlan.bind`` over the orbit on three fields: the
    turbulence, the sphere (its outside empty) and the turbulence dimmed to
    2 % (deep rays).  B1 (the float32 volume, the transfer in its epilogue,
    as ``render`` launches it), B6 and B7 (``render_pooled``), each bound
    from its own data, bit-equal on every frame to the unbound kernel and to
    the bound plain march; their times bound and unbound, the bind's cost,
    the samples gathered and skipped.  Returns the kernels line's three
    bound entries (their numbers the sphere's, every field's beside)."""
    from volumerenderer_tpu_torch import as_normalized_volume
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.raycast import (apply_reference_transfer,
                                                      composite_march_steps)
    from volumerenderer_tpu_torch.ops.sampling import slab_pool_sampler

    plans = [RK.CompositingPlan(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]
    p0 = plans[0]
    wrappers = {"composite_march": RK.composite_march_cuda,
                "composite_march_pooled_narrow": RK.composite_march_pooled_narrow_cuda,
                "composite_march_pooled_pair16": RK.composite_march_pooled_pair16_cuda}
    fields = {"turbulence": turb, "sphere": sphere, "dim2": turb * 0.02}
    data, bounds = {}, {}
    for fname, vol in fields.items():
        u8 = RK.quantize_u8(vol)
        data[fname] = {"composite_march": (vol,),
                       "composite_march_pooled_narrow": RK.build_slab_pool_narrow(u8),
                       "composite_march_pooled_pair16": RK.build_slab_pool(u8)}
        bounds[fname] = {"composite_march": p0.bind(vol)}
        bounds[fname].update({n: p0.bind(pool=data[fname][n]) for n in wrappers
                              if n != "composite_march"})

    def launch(fname, name, p, bound):
        # the kernel as render and render_pooled launch it; with a bound, the
        # bound instantiation whether or not its grid holds an empty block
        return wrappers[name](*data[fname][name], p.entry_uv, p.dir_step, p.hit, p.max_samples,
                              p.wrap, bound=bound)

    # the bound path, as a user drives it, on the sphere (whose grid holds
    # empty blocks, so render marches bound): one bind per data, shared by
    # the 16 plans, then render(..., bound=) / render_pooled over the orbit
    if not all(b.has_empty for b in bounds["sphere"].values()):
        raise AssertionError("the sphere's grid holds no empty block")
    for w in wrappers.values():
        w.launches = 0
    renders = dict.fromkeys(wrappers, 0)
    for name in wrappers:
        for p in plans:
            if name == "composite_march":
                p.render(*data["sphere"][name], bound=bounds["sphere"][name])
            else:
                p.render_pooled(*data["sphere"][name], bound=bounds["sphere"][name])
            renders[name] += 1
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    if launches != renders:
        raise AssertionError(f"bound compositing path: launches {launches}, renders {renders}")

    per_field = {n: {} for n in wrappers}
    err = dict.fromkeys(wrappers, 0.0)
    for fname, vol in fields.items():
        u8 = RK.quantize_u8(vol)
        vol_plain = as_normalized_volume(u8)
        cb = bounds[fname]["composite_march"]
        # bit for bit on every frame: bound = unbound = the bound plain march;
        # the bound plain pooled march (the pool sampler) on frames 0 and 15
        n_equal = 0
        for i, p in enumerate(plans):
            args = (p.entry_uv, p.dir_step, p.hit.bool(), p.max_samples)
            c, a = composite_march_steps(vol_plain, *args, bound=cb)
            plain = (apply_reference_transfer(c, a), a)
            if i in (0, N_FRAMES - 1):
                for name in ("composite_march_pooled_narrow", "composite_march_pooled_pair16"):
                    sampler = slab_pool_sampler(*data[fname][name], p.dims)
                    cp, ap = composite_march_steps(sampler, *args, bound=bounds[fname][name])
                    if not (torch.equal(cp, c) and torch.equal(ap, a)):
                        raise AssertionError(f"bound plain pooled march {name} on {fname} frame "
                                             f"{i} differs from the bound plain march")
            rendered = p.render(vol, bound=cb)
            for name in wrappers:
                got = launch(fname, name, p, bounds[fname][name])
                unbound = launch(fname, name, p, None)
                if not all(torch.equal(x, y) and torch.equal(x, z) and torch.equal(x, r)
                           for x, y, z, r in zip(got, unbound, plain, rendered)):
                    raise AssertionError(f"bound {name} on {fname} frame {i}: not bit-equal to "
                                         f"the unbound kernel and the bound plain march")
                err[name] = max(err[name], float((got[0] - plain[0]).abs().max()),
                                float((got[1] - plain[1]).abs().max()))
                n_equal += 1
        # the bind's cost, from each source, and the samples gathered and
        # skipped (every plan's; each pooled grid is the volume's, checked)
        for name in wrappers:
            if not torch.equal(bounds[fname][name].grid, cb.grid):
                raise AssertionError(f"{name}'s grid on {fname} is not the volume's")
        bind_ms = {"volume": time_ms(lambda: p0.bind(vol)),
                   "volume_mip8": time_ms(lambda: p0.bind(vol, mip8=RK.block_max8(vol))),
                   "pool_narrow": time_ms(lambda: p0.bind(
                       pool=data[fname]["composite_march_pooled_narrow"])),
                   "pool_pair16": time_ms(lambda: p0.bind(
                       pool=data[fname]["composite_march_pooled_pair16"]))}
        skipped = torch.zeros(p0.shape, device=dev)
        samples = 0.0
        touched = torch.zeros(vol.numel(), dtype=torch.bool, device=dev)
        words = {n: torch.zeros(data[fname][n][0].numel(), dtype=torch.bool, device=dev)
                 for n in wrappers if n != "composite_march"}
        touched_all = 0.0
        words_all = dict.fromkeys(words, 0.0)
        for p in plans:
            touched.zero_()
            for m in words.values():
                m.zero_()
            n = composite_samples(p, vol_plain, touched=touched,
                                  pools=[(words[k], *data[fname][k]) for k in words],
                                  cbound=cb, skipped=skipped)
            samples += float(n.sum()) / N_FRAMES
            touched_all += float(touched.sum()) / N_FRAMES
            for k in words:
                words_all[k] += float(words[k].sum()) / N_FRAMES
        n_skipped = float(skipped.sum()) / N_FRAMES
        gathered = samples - n_skipped
        rays_io = sum(nbytes(p.entry_uv, p.dir_step, p.hit) for p in plans) / N_FRAMES
        out_io = rays_io + RGBA_BYTES * W * H + nbytes(cb.grid)
        for name in wrappers:
            f32 = name == "composite_march"
            step = OPS_PER_STEP["composite_f32" if f32 else "composite"]
            ops = gathered * (step + BIND_CLASSIFY_OPS) + n_skipped * COMP_SKIPPED_OPS \
                + TRANSFER_OPS_PER_RAY * W * H
            read = 4 * touched_all if f32 else \
                words_all[name] * data[fname][name][0].element_size() \
                + nbytes(data[fname][name][1])
            ms_b = time_ms(lambda: [launch(fname, name, p, bounds[fname][name])
                                    for p in plans]) / N_FRAMES
            ms_u = time_ms(lambda: [launch(fname, name, p, None) for p in plans]) / N_FRAMES
            per_field[name][fname] = {
                "ms_bound": ms_b, "ms_unbound": ms_u, "bound_over_unbound": ms_b / ms_u,
                **bound(read + out_io, ops, samples, W * H),
                "samples_per_ray": samples / (W * H), "gathered_per_ray": gathered / (W * H),
                "skipped_per_ray": n_skipped / (W * H),
                "empty_block_share": float((cb.grid[..., 1] == 0).float().mean()),
                "frames_bit_equal": n_equal // len(wrappers)}
        # the bound plain marches on frame 0: B1's on the volume, B6's and
        # B7's through the pool sampler of their pool
        args0 = (p0.entry_uv, p0.dir_step, p0.hit.bool(), p0.max_samples)
        for name in wrappers:
            sampler = vol_plain if name == "composite_march" else \
                slab_pool_sampler(*data[fname][name], p0.dims)
            per_field[name][fname]["plain_bound_ms_frame0"] = time_ms(
                lambda: composite_march_steps(sampler, *args0, bound=bounds[fname][name]),
                reps=1)
        emit({"phase": "composite_bind", "volume": fname, "frames": N_FRAMES,
              "bind_ms": bind_ms, "empty_block_share": per_field["composite_march"][fname][
                  "empty_block_share"], "render_marches_bound": cb.has_empty,
              "samples_per_ray": samples / (W * H), "skipped_per_ray": n_skipped / (W * H),
              "ms_per_launch": {n: {k: per_field[n][fname][k]
                                    for k in ("ms_bound", "ms_unbound", "bound_ms")}
                                for n in wrappers},
              "bit_equal_frames": n_equal // len(wrappers), "gpu": smi})
    return [{"name": f"{name}_bound", "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": REPLACES if name == "composite_march" else POOLED_REPLACES[name],
             "launches": launches[name], "max_abs_err": err[name],
             "ms": per_field[name]["sphere"]["ms_bound"],
             "plain_ms": per_field[name]["sphere"]["plain_bound_ms_frame0"],
             **{k: per_field[name]["sphere"][k] for k in ("bound_ms", "bound_by", "library_ms",
                                                           "bytes", "ops", "samples_per_ray")},
             "field": "sphere", "per_field": per_field[name]} for name in wrappers]


def run_skip_empty(dev, smi: str, tree, turb, bundles) -> None:
    """``CompressedRenderer.make_plan``'s ``skip_empty`` on the smoke's tree:
    each mode's plan with and without the bind, pooled and dense, every
    orbit frame equal; plan and frame times.  The isosurface's two bind
    sources on the pooled plan (its pool's bytes, which ``make_plan`` takes,
    and the tree's mip8), and ``render_isosurface_kernel``'s one-shot bind
    against no bind on the turbulence at its median (its default)."""
    from volumerenderer_tpu_torch.models import CompressedRenderer
    from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK

    ren = CompressedRenderer(tree, dev)
    iso_cut = IK.volume_median(ren.volume_at())
    out = {}
    for mode in ("compositing", "isosurface"):
        for pooled in (False, True):
            kw = dict(mode=mode, iso_value=iso_cut, pooled=pooled)
            frames = {}
            plan_ms = {}
            for skip in (True, False):
                ren.make_plan(bundles[0], skip_empty=skip, **kw)  # pools and mip built once
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frames[skip] = [ren.make_plan(r, skip_empty=skip, **kw) for r in bundles]
                torch.cuda.synchronize()
                plan_ms[skip] = 1e3 * (time.perf_counter() - t0) / N_FRAMES
            for fb, fu in zip(frames[True], frames[False]):
                got, want = fb(), fu()
                if not all(torch.equal(x, y) for x, y in zip(got, want)) \
                        or not bool(torch.isfinite(got[0]).all()):
                    raise AssertionError(f"make_plan({mode}, pooled={pooled}): the bound frame "
                                         f"differs from the unbound one")
            out[f"{mode}_{'pooled' if pooled else 'dense'}"] = {
                "plan_ms_bound": plan_ms[True], "plan_ms_unbound": plan_ms[False],
                "frame_ms_bound": time_ms(lambda: [f() for f in frames[True]]) / N_FRAMES,
                "frame_ms_unbound": time_ms(lambda: [f() for f in frames[False]]) / N_FRAMES,
                "frames_equal": N_FRAMES}
    # the pooled isosurface's bind sources: the pool's bytes (min and max
    # gates) against the tree's mip8 (max gates only)
    iplans = [IK.IsosurfacePlan(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]
    pool, smap = ren.slab_pool_at(fmt="narrowf32")
    mip = ren.mip8_at()
    sources = {"pool": lambda: iplans[0].bind(iso_value=iso_cut, pool=(pool, smap)),
               "mip8": lambda: iplans[0].bind(iso_value=iso_cut, pool=(pool, smap), mip8=mip)}
    iso_bind = {}
    for name, bind in sources.items():
        b = bind()
        iso_bind[name] = {
            "bind_ms": time_ms(bind),
            "frame_ms": time_ms(lambda: [p.render_pooled(pool, smap, iso_cut, bound=b)
                                         for p in iplans]) / N_FRAMES}
    iso_bind["unbound_frame_ms"] = time_ms(lambda: [p.render_pooled(pool, smap, iso_cut)
                                                    for p in iplans]) / N_FRAMES
    # render_isosurface_kernel: a bind inside every call against none
    iso_med = IK.volume_median(turb)
    r0 = bundles[0]
    one_shot = {skip: time_ms(lambda: IK.render_isosurface_kernel(
        turb, r0.entry_uv, r0.direction, r0.hit, iso_med, skip_empty=skip))
        for skip in (True, False)}
    a = IK.render_isosurface_kernel(turb, r0.entry_uv, r0.direction, r0.hit, iso_med,
                                    skip_empty=True)
    b = IK.render_isosurface_kernel(turb, r0.entry_uv, r0.direction, r0.hit, iso_med,
                                    skip_empty=False)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("render_isosurface_kernel: skip_empty changed the image")
    emit({"phase": "skip_empty", "iso_cut_median": iso_cut, "make_plan": out,
          "iso_pooled_bind_sources": iso_bind,
          "render_isosurface_kernel_ms": {"skip_empty": one_shot[True],
                                          "no_bind": one_shot[False]},
          "gpu": smi})


def run_diff_finetune(dev, smi: str, tree, turb, bundles) -> None:
    """A compressed-domain fine-tune step on the smoke's tree at 1024^2:
    ``CompressedRenderer.diff_decoder`` -> ``make_render_tf_voxel`` (B4
    forward, B5 backward) -> MSE against the source turbulence's image ->
    gradients of the Δ map and the leaf scalars.  The forward at the tree's
    own Δ map equals ``level_cut_device / 255`` bit for bit; the gradients
    are finite; B4 and B5 launch once per step; the step and its layers are
    timed by CUDA events."""
    from volumerenderer_tpu_torch import TFParams
    from volumerenderer_tpu_torch.codecs.device import level_cut_device
    from volumerenderer_tpu_torch.models import CompressedRenderer
    from volumerenderer_tpu_torch.ops.cuda import tf_kernel as TK
    from volumerenderer_tpu_torch.ops.cuda import voxel_grad_kernel as VK
    from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import CompositingPlan

    ren = CompressedRenderer(tree, dev)
    dec = ren.diff_decoder()
    ref = level_cut_device(ren.dtree, ren.spec).to(torch.float32) / 255.0
    if not torch.equal(dec(dec.dm0), ref):
        raise AssertionError("DiffDecoder at dm0 differs from level_cut_device / 255")
    r0 = bundles[0]
    plan = CompositingPlan(r0.entry_uv, r0.direction, r0.hit, VOLUME[::-1])
    f = VK.make_render_tf_voxel(plan)
    params = TFParams.reference(dev)
    target, _ = plan.render(turb)
    dm = dec.dm0.clone().requires_grad_(True)
    adj = dec.zero_leaf_adjust().requires_grad_(True)

    def step():
        rgb, _ = f(params, dec(dm, adj))
        loss = torch.mean((rgb - target) ** 2)
        return (loss, *torch.autograd.grad(loss, (dm, adj)))

    step()
    TK.tf_march_cuda.f32_launches = 0
    VK.voxel_grad_cuda.launches = 0
    loss, g_dm, g_adj = step()
    torch.cuda.synchronize()
    launches = {"tf_march_f32": TK.tf_march_cuda.f32_launches,
                "voxel_grad": VK.voxel_grad_cuda.launches}
    if launches != {"tf_march_f32": 1, "voxel_grad": 1}:
        raise AssertionError(f"a fine-tune step launched {launches}; expected B4 and B5 once")
    if not (bool(torch.isfinite(g_dm).all()) and bool(torch.isfinite(g_adj).all())
            and float(g_adj.abs().sum()) > 0 and math.isfinite(float(loss.detach()))):
        raise AssertionError("fine-tune step: the gradients are not finite or all zero")
    vol = dec(dm, adj).detach().requires_grad_(True)
    cot = torch.ones_like(vol)
    layers = {
        "step": time_ms(step),
        "decode_forward": time_ms(lambda: dec(dm, adj)),
        "decode_forward_backward": time_ms(lambda: torch.autograd.grad(dec(dm, adj), (dm, adj),
                                                                       cot)),
        "render_forward_b4": time_ms(lambda: f(params, vol.detach())),
        "render_forward_backward_b4_b5": time_ms(lambda: torch.autograd.grad(
            torch.mean((f(params, vol)[0] - target) ** 2), vol)),
        "forward_frame": time_ms(lambda: plan.render(turb))}
    emit({"phase": "diff_finetune", "shape": [H, W], "volume": list(VOLUME),
          "cut_depth": dec.cut_depth, "leaves": dec.num_leaves, "loss": float(loss.detach()),
          "forward_equal_to_level_cut_device": True,
          "grad_dm_abs_sum": float(g_dm.abs().sum()),
          "grad_leaf_adjust_abs_sum": float(g_adj.abs().sum()),
          "launches_per_step": launches, "ms": layers,
          "step_over_forward_frame": layers["step"] / layers["forward_frame"], "gpu": smi})


def run_midrange(dev, smi: str, source, tree, bundles) -> None:
    """The mid-range codec on the smoke's source: the host build (tolerance
    and epochs of the codec phase), its midpoint channel equal to the codec
    phase's ``KdTree`` array for array, the range channel decoded on the
    card equal to the host's, and a pooled compositing frame through
    ``CompressedRenderer(MidRangeTree)`` equal to the KdTree's."""
    from volumerenderer_tpu_torch.codecs import device as CD
    from volumerenderer_tpu_torch.codecs import midrange as MR
    from volumerenderer_tpu_torch.models import CompressedRenderer

    t0 = time.perf_counter()
    mt = MR.build(source, tolerance=TREE_TOLERANCE, max_epochs=TREE_EPOCHS)
    build_s = time.perf_counter() - t0
    pairs = [(mt.mid.distance_map, tree.distance_map), (mt.mid.chain_codes, tree.chain_codes),
             (mt.mid.leaf_recon, tree.leaf_recon), (mt.mid.leaf_truth, tree.leaf_truth),
             *zip(mt.mid.level_codes, tree.level_codes)]
    if mt.num_active_nodes != tree.num_active_nodes \
            or not all(np.array_equal(a, b) for a, b in pairs):
        raise AssertionError("the mid-range tree's midpoint channel differs from the KdTree")
    _, rng_dev, spec = MR.to_device_pair(mt, dev)
    t0 = time.perf_counter()
    host_range = MR.level_cut_range(mt)
    range_host_s = time.perf_counter() - t0
    if not np.array_equal(CD.level_cut_device(rng_dev, spec).cpu().numpy(), host_range):
        raise AssertionError("the range channel's device decode differs from the host's")
    frame = CompressedRenderer(mt, dev).make_plan(bundles[0], pooled=True)()
    want = CompressedRenderer(tree, dev).make_plan(bundles[0], pooled=True)()
    if not all(torch.equal(x, y) for x, y in zip(frame, want)) \
            or not bool(torch.isfinite(frame[0]).all()):
        raise AssertionError("CompressedRenderer(MidRangeTree) differs from its KdTree's frame")
    emit({"phase": "midrange", "volume": list(VOLUME), "tolerance": TREE_TOLERANCE,
          "max_epochs": TREE_EPOCHS, "build_s": build_s, "num_active_nodes": mt.num_active_nodes,
          "mid_equal_to_kdtree": True, "range_device_equal_to_host": True,
          "range_level_cut_host_s": range_host_s,
          "range_mean": float(host_range.mean()), "frame_equal_to_kdtree": True, "gpu": smi})


def once_ms(fn) -> float:
    """One call of ``fn`` (the first, cold), in ms by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def hashed_trees_equal(a, b) -> bool:
    return a.tree_depth == b.tree_depth and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in HASHED_FIELDS)


def run_config4(dev, smi: str) -> None:
    """BASELINE config 4 at 256^3: 8 synthetic 128^3 bricks -> the hashed
    kd-tree, built natively on the host (``csrc/hashed_build.cu``) -> its
    chunked decode on the card -> a TF fit of 5 steps through B4 at 1024^2
    against a 0.5-gray target.  The decode equals the same function on CPU
    tensors, flat and chunked; at 64^3 it equals the host ``level_cut``; the
    native builder equals the Python one at 16x32x16 and 32^3; B4 on the
    decoded volume matches its plain version within the TF bar; the losses
    fall; B4 launched once per step."""
    from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.codecs import hashed as HC
    from volumerenderer_tpu_torch.diff import closed_form as CF
    from volumerenderer_tpu_torch.io.bricks import BrickGrid, load_bricks, synthetic_brick_source
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
    from volumerenderer_tpu_torch.models import plan_compositing
    from volumerenderer_tpu_torch.ops.cuda import tf_kernel as TK
    from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import quantize_u8

    # the native builder against the Python one
    for shape in ((16, 32, 16), (32, 32, 32)):
        v = turbulence_volume(shape, seed=5)
        if not hashed_trees_equal(HC.build(v, CONFIG4_TOLERANCE, use_native=True),
                                  HC.build(v, CONFIG4_TOLERANCE, use_native=False)):
            raise AssertionError(f"the native hashed builder differs from the Python one at "
                                 f"{shape}")
    # at 64^3 (32^3 bricks) the device decode against the host level cut
    g64 = BrickGrid(brick_dims=(32, 32, 32), grid=(2, 2, 2))
    small = load_bricks(synthetic_brick_source(g64), g64, 8, 2, 2, 2, CONFIG4_TIMESTEP)
    t64 = HC.build(small, CONFIG4_TOLERANCE)
    t0 = time.perf_counter()
    host64 = HC.level_cut(t64)
    host64_s = time.perf_counter() - t0
    dev64 = HC.level_cut_device_hashed(t64, HC.to_device_hashed(t64, dev))
    if not np.array_equal(dev64.cpu().numpy(), host64):
        raise AssertionError("64^3: the hashed device decode differs from the host level_cut")

    grid = BrickGrid(brick_dims=CONFIG4_BRICK, grid=(2, 2, 2))
    t0 = time.perf_counter()
    multi = load_bricks(synthetic_brick_source(grid), grid, 8, 2, 2, 2, CONFIG4_TIMESTEP)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = HC.build(multi, CONFIG4_TOLERANCE)  # native on a machine with a CUDA device
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dtree = HC.to_device_hashed(tree, dev)
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    holder = {}
    cold_ms = once_ms(lambda: holder.setdefault("cut", HC.level_cut_device_hashed(tree, dtree)))
    dec = holder["cut"]
    warm_ms = time_ms(lambda: HC.level_cut_device_hashed(tree, dtree))
    flat = HC.level_cut_device_hashed(tree, dtree, chunk_bits=tree.orig_depth)
    flat_ms = time_ms(lambda: HC.level_cut_device_hashed(tree, dtree, chunk_bits=tree.orig_depth))
    cpu_tree = HC.to_device_hashed(tree, "cpu")
    t0 = time.perf_counter()
    cpu_chunked = HC.level_cut_device_hashed(tree, cpu_tree)
    cpu_chunked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_flat = HC.level_cut_device_hashed(tree, cpu_tree, chunk_bits=tree.orig_depth)
    cpu_flat_s = time.perf_counter() - t0
    dec_cpu = dec.cpu()
    if dec.shape != tuple(VOLUME) or not (torch.equal(flat.cpu(), dec_cpu)
                                          and torch.equal(cpu_chunked, dec_cpu)
                                          and torch.equal(cpu_flat, dec_cpu)):
        raise AssertionError("256^3: the hashed decode on the card differs from the same "
                             "decode on CPU tensors or from its flat form")
    err = (dec_cpu.to(torch.int32) - torch.from_numpy(multi).to(torch.int32)).abs()
    del cpu_tree, cpu_chunked, cpu_flat, flat

    vol = as_normalized_volume(dec)
    rays = generate_rays(Camera(width=W, height=H), device=dev)
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, VOLUME[::-1])
    reference = TFParams.reference(dev)
    # B4 on the decoded volume against its plain version
    tf = CF.tf_scalars(reference)
    k = TK.tf_march_cuda(vol, plan.entry_uv, plan.dir_step, plan.hit, tf)
    p = CF.tf_march_steps(as_normalized_volume(quantize_u8(vol)), plan.entry_uv, plan.dir_step,
                          plan.hit.bool(), tf)
    torch.cuda.synchronize()
    res = compare(k[:2], p[:2], W * H)
    rel = torch.stack([(a - b).abs() / torch.clamp(b.abs(), min=1.0)
                       for a, b in zip(k[2:], p[2:])]).amax(dim=0)
    if float(rel.max()) > CONFIG4_TF_RTOL:
        raise AssertionError(f"config4: B4's sums on the decoded volume differ from the plain "
                             f"version's by {float(rel.max())} relative (bar {CONFIG4_TF_RTOL})")

    # the fit, as a user drives it; the counts cover exactly these steps
    target = torch.full((H, W, 3), 0.5, device=dev)
    f_tf = TK.make_render_tf_kernel(plan)
    TK.tf_march_cuda.launches = TK.tf_march_cuda.f32_launches = 0
    params, losses, step_ms = reference, [], []
    for _ in range(FIT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = TK.tf_fit_step_fast(f_tf, params, vol, target, lr=FIT_LR)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = {"tf_march_f32": TK.tf_march_cuda.f32_launches,
                "tf_march": TK.tf_march_cuda.launches - TK.tf_march_cuda.f32_launches}
    if launches != {"tf_march_f32": FIT_STEPS, "tf_march": 0}:
        raise AssertionError(f"config4: {FIT_STEPS} fit steps launched {launches}")
    if not all(math.isfinite(x) for x in losses) or \
            not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"config4: the fit's losses {losses} do not decrease")
    emit({"phase": "config4", "volume": list(VOLUME), "bricks": 8,
          "brick_dims": list(CONFIG4_BRICK), "timestep": CONFIG4_TIMESTEP,
          "tolerance": CONFIG4_TOLERANCE, "load_s": load_s, "build_s": build_s,
          "builder": "native", "collisions": tree.num_collisions, "orig_depth": tree.orig_depth,
          "tree_depth": tree.tree_depth, "upload_ms": upload_ms,
          "decode_cold_ms": cold_ms, "decode_warm_ms": warm_ms, "decode_flat_warm_ms": flat_ms,
          "decode_cpu_chunked_s": cpu_chunked_s, "decode_cpu_flat_s": cpu_flat_s,
          "decode_equal_cpu_flat_and_chunked": True, "decode_max_err": int(err.max()),
          "decode_mean_err": float(err.double().mean()),
          "decode_64_equal_host_level_cut": True, "host_level_cut_64_s": host64_s,
          "native_equal_python": ["16x32x16", "32x32x32"], "b4_vs_plain": res,
          "b4_sums_max_rel_err": float(rel.max()), "hw": [H, W], "fit_losses": losses,
          "fit_lr": FIT_LR, "fit_step_ms": step_ms, "launches": launches, "gpu": smi})


def run_device_build(dev, smi: str, source: np.ndarray, tree, host_build_s: float,
                     bundles) -> None:
    """``build_device`` of the codec phase's 256^3 source on the card: in
    exact-seed mode equal to the host ``kdtree.build`` tree (``tree``)
    array for array, its orbit frame 0 through ``CompressedRenderer(...)
    .make_plan(pooled=True)`` (B7) equal to the host tree's; in parallel
    mode held by quality."""
    from volumerenderer_tpu_torch.codecs import kdtree as KT
    from volumerenderer_tpu_torch.codecs import device_build as DB
    from volumerenderer_tpu_torch.codecs.device_build import build_device
    from volumerenderer_tpu_torch.models import CompressedRenderer
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK

    seconds = {}
    trees = {}
    for mode in ("exact", "parallel"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trees[mode] = build_device(source, tolerance=TREE_TOLERANCE, max_epochs=TREE_EPOCHS,
                                   seed_mode=mode, device=dev)
        seconds[mode] = time.perf_counter() - t0
    got = trees["exact"]
    host = {m: DB.to_host(t) for m, t in trees.items()}
    pairs = [(host["exact"].distance_map, tree.distance_map),
             (host["exact"].chain_codes, tree.chain_codes),
             (host["exact"].leaf_recon, tree.leaf_recon),
             *zip(host["exact"].level_codes, tree.level_codes)]
    if got.num_active_nodes != tree.num_active_nodes or len(got.level_codes) != \
            len(tree.level_codes) or not all(np.array_equal(a, b) for a, b in pairs):
        raise AssertionError("build_device (exact seed) differs from kdtree.build")
    err = {m: KT.measure_mean_error(KT.level_cut(t), source)
           for m, t in (("host", tree), ("parallel", host["parallel"]))}
    if not err["parallel"] <= err["host"] * 1.25 + 0.5:
        raise AssertionError(f"build_device (parallel seed): mean error {err['parallel']} "
                             f"against the host build's {err['host']}")
    want = CompressedRenderer(tree, dev).make_plan(bundles[0], pooled=True)()
    RK.composite_march_pooled_pair16_cuda.launches = 0
    frame = CompressedRenderer(got, dev).make_plan(bundles[0], pooled=True)()
    torch.cuda.synchronize()
    b7 = RK.composite_march_pooled_pair16_cuda.launches
    if b7 != 1 or not all(torch.equal(x, y) for x, y in zip(frame, want)) \
            or not bool(torch.isfinite(frame[0]).all()):
        raise AssertionError(f"build_device's tree: frame 0 differs from the host tree's, or "
                             f"B7 launched {b7} times")
    emit({"phase": "device_build", "volume": list(VOLUME), "tolerance": TREE_TOLERANCE,
          "max_epochs": TREE_EPOCHS, "build_device_exact_s": seconds["exact"],
          "build_device_parallel_s": seconds["parallel"], "host_build_s": host_build_s,
          "exact_equal_to_host_build": True,
          "distance_map_parallel": trees["parallel"].distance_map.tolist(),
          "distance_map_exact": got.distance_map.tolist(),
          "mean_err": err, "frame0_equal_to_host_tree": True,
          "launches": {"composite_march_pooled_pair16": b7}, "gpu": smi})


def run_octree(dev, smi: str, source: np.ndarray, bundles) -> None:
    """``octree.build`` of the 256^3 source on the host, its level cuts at
    depths 3, 6 and 8, and the depth-6 cut rendered through the compositing
    plan (B1) on orbit frame 0, bit-equal to its plain march."""
    from volumerenderer_tpu_torch import as_normalized_volume
    from volumerenderer_tpu_torch.codecs import octree as OC
    from volumerenderer_tpu_torch.models import plan_compositing
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.raycast import apply_reference_transfer, composite_march_steps

    t0 = time.perf_counter()
    ot = OC.build(source)
    build_s = time.perf_counter() - t0
    cuts, cut_s, err = {}, {}, {}
    for d in OCTREE_CUTS:
        t0 = time.perf_counter()
        cuts[d] = OC.level_cut(ot, d)
        cut_s[d] = time.perf_counter() - t0
        err[d] = float(np.abs(cuts[d].astype(np.int32) - source.astype(np.int32)).mean())
    if not np.array_equal(OC.level_cut(ot, ot.depth), source) \
            or any(c.shape != source.shape for c in cuts.values()):
        raise AssertionError("octree: the full-depth cut is not the source")
    vol = as_normalized_volume(cuts[OCTREE_RENDER_CUT], device=dev)
    r0 = bundles[0]
    plan = plan_compositing(r0.entry_uv, r0.direction, r0.hit, VOLUME[::-1])
    RK.composite_march_cuda.f32_launches = 0
    rgb, alpha = plan.render(vol)
    torch.cuda.synchronize()
    b1 = RK.composite_march_cuda.f32_launches
    c_p, a_p = composite_march_steps(as_normalized_volume(RK.quantize_u8(vol)), plan.entry_uv,
                                     plan.dir_step, plan.hit.bool(), plan.max_samples)
    if b1 != 1 or not (torch.equal(rgb, apply_reference_transfer(c_p, a_p))
                       and torch.equal(alpha, a_p)):
        raise AssertionError(f"octree: the depth-{OCTREE_RENDER_CUT} frame differs from its "
                             f"plain march, or B1 launched {b1} times")
    emit({"phase": "octree", "volume": list(VOLUME), "depth": ot.depth,
          "node_count": ot.node_count(), "build_s": build_s,
          "level_cut_s": {str(d): cut_s[d] for d in OCTREE_CUTS},
          "mean_err": {str(d): err[d] for d in OCTREE_CUTS},
          "render_cut": OCTREE_RENDER_CUT, "frame_bit_equal_plain": True,
          "alpha_sum": float(alpha.sum()), "launches": {"composite_march_f32": b1},
          "gpu": smi})


def run_checkpoint(dev, smi: str, tree, source: np.ndarray, work: Path) -> None:
    """The codec phase's 256^3 tree through its checkpoint file:
    ``kdtree.save``, ``open_tree_full`` (the native inverse walk, verified by
    serializing again), equal to the tree array for array; the native
    ``decode_preorder`` of the file's stream at ``max_depth`` equal to the
    host ``level_cut`` and to the device decode of the opened tree; the
    native ``build_arbitrary`` equal to ``SequentialKdTree.build`` on a
    24x20x12 volume, and timed on a 192x160x96 one (neither side a power of
    two but 160 = 5 x 32)."""
    from volumerenderer_tpu_torch.codecs import device as CD
    from volumerenderer_tpu_torch.codecs import kdtree as KT
    from volumerenderer_tpu_torch.codecs import reference_impl as RI
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume

    path = work / "tree_256.bin"
    t0 = time.perf_counter()
    KT.save(tree, str(path))
    save_s = time.perf_counter() - t0
    want_bytes = KT.FILE_HEADER.size + tree.max_depth + 1 + (tree.num_active_nodes + 3) // 4
    t0 = time.perf_counter()
    opened = KT.open_tree_full(str(path))   # the native walk on a machine with a CUDA device
    open_s = time.perf_counter() - t0
    raw = KT.open_tree(str(path))
    t0 = time.perf_counter()
    KT.preorder_to_levels(raw["preorder"], tree.orig_depth, tree.max_depth, use_native=True)
    walk_s = time.perf_counter() - t0
    pairs = [(opened.distance_map, tree.distance_map), (opened.chain_codes, tree.chain_codes),
             *zip(opened.level_codes, tree.level_codes)]
    if path.stat().st_size != want_bytes or opened.num_active_nodes != tree.num_active_nodes \
            or len(opened.level_codes) != len(tree.level_codes) \
            or list(opened.schedule) != list(tree.schedule) \
            or not all(np.array_equal(a, b) for a, b in pairs):
        raise AssertionError("checkpoint: the opened tree differs from the saved one")
    X, Y, Z = tree.dims
    t0 = time.perf_counter()
    native_cut = RI.decode_preorder(raw["preorder"], raw["distance_map"], X, Y, Z,
                                    tree.orig_depth, tree.max_depth, tree.max_depth)
    decode_s = time.perf_counter() - t0
    host_cut = KT.level_cut(tree)
    device_cut = CD.level_cut_device(*CD.to_device(opened, dev)).cpu().numpy()
    if not (np.array_equal(native_cut, host_cut) and np.array_equal(device_cut, host_cut)):
        raise AssertionError("checkpoint: the native decode_preorder, the host level_cut and "
                             "the device decode of the opened tree differ")

    small = turbulence_volume(CHECKPOINT_SMALL, seed=CHECKPOINT_SEED)
    Zs, Ys, Xs = small.shape
    seq = RI.SequentialKdTree(small.reshape(-1), Xs, Ys, Zs, 6, 5)
    t0 = time.perf_counter()
    seq.build()
    seq_s = time.perf_counter() - t0
    nat = RI.build_arbitrary(small, 6, 5)   # native on a machine with a CUDA device
    if (nat.num_active_nodes, nat.orig_depth) != (seq.num_active_nodes, seq.orig_depth) or \
            not all(np.array_equal(getattr(nat, f), getattr(seq, f))
                    for f in ("distance_map", "preorder", "recon")):
        raise AssertionError(f"checkpoint: the native build_arbitrary differs from "
                             f"SequentialKdTree.build at {CHECKPOINT_SMALL[::-1]}")
    large = turbulence_volume(CHECKPOINT_LARGE, seed=CHECKPOINT_SEED)
    t0 = time.perf_counter()
    big = RI.build_arbitrary(large, 6, 5)
    big_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_cut = big.level_cut(big.max_depth)
    big_decode_s = time.perf_counter() - t0
    emit({"phase": "checkpoint", "volume": list(VOLUME), "file_bytes": path.stat().st_size,
          "num_active_nodes": tree.num_active_nodes, "save_s": save_s,
          "open_tree_full_s": open_s, "open_tree_full_walk": "native, verified",
          "native_preorder_to_levels_s": walk_s, "opened_equal_saved": True,
          "native_decode_preorder_s": decode_s, "native_decode_equal_host_and_device": True,
          "build_arbitrary_small_xyz": list(CHECKPOINT_SMALL[::-1]),
          "sequential_build_s": seq_s, "native_equal_sequential": True,
          "build_arbitrary_large_xyz": list(CHECKPOINT_LARGE[::-1]),
          "native_build_s": big_s, "native_build_nodes": big.num_active_nodes,
          "native_build_err": {"max": int(np.abs(big_cut.astype(np.int32) - large).max()),
                               "mean": float(np.abs(big_cut.astype(np.int32) - large).mean())},
          "native_decode_large_s": big_decode_s, "gpu": smi})


def trace_kernels(trace_file: str) -> dict:
    """Device kernels of a Chrome trace by name: how many launches each."""
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = e.get("name", "")[:60]
            out[name] = out.get(name, 0) + 1
    return out


def run_app(dev, smi: str, work: Path) -> None:
    """``app.run(AppConfig(), num_frames=APP_FRAMES)`` in both render
    modes, as a user calls it: the 256^3 turbulence of seed 273 (the
    timestep), the kd-tree at tolerance 6 with 5 epochs, cut at its full
    depth, the 1600x1200 window; compositing marches 300 samples, the
    isosurface is at 40/255.  Each frame is one plan call: B7, or B8 and the
    pooled shade, and no other march.  Then, on the tree opened from the
    file ``run`` saved: frame 0 bit-equal to the plain pooled march, within
    the plain path's bars (``use_pallas_kernel=False``), a frame by CUDA
    events and two frames under ``timed(profile=True)``."""
    from volumerenderer_tpu_torch import app as TA
    from volumerenderer_tpu_torch import generate_rays
    from volumerenderer_tpu_torch.codecs import kdtree as KT
    from volumerenderer_tpu_torch.config import AppConfig, RenderConfig
    from volumerenderer_tpu_torch.models import CompressedRenderer
    from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.isosurface import iso_march_steps, shade_hits
    from volumerenderer_tpu_torch.ops.raycast import apply_reference_transfer, composite_march_steps
    from volumerenderer_tpu_torch.ops.sampling import slab_pool_sampler
    from volumerenderer_tpu_torch.utils.timer import DebugTimer, timed

    counted = {"composite_march_pooled_pair16": RK.composite_march_pooled_pair16_cuda,
               "composite_march_pooled_narrow": RK.composite_march_pooled_narrow_cuda,
               "composite_march": RK.composite_march_cuda,
               "iso_march_pooled_narrow": IK.iso_march_pooled_narrow_cuda,
               "iso_march_pooled_pair16": IK.iso_march_pooled_pair16_cuda,
               "iso_march": IK.iso_march_cuda, "iso_shade_pooled": IK.iso_shade_pooled_cuda,
               "iso_shade": IK.iso_shade_cuda}
    for mode in ("compositing", "isosurface"):
        cfg = AppConfig(render=RenderConfig(render_mode=mode),
                        tree_path=str(work / f"app_{mode}.bin"))
        for f in counted.values():
            f.launches = 0
        DebugTimer.reset()
        t0 = time.perf_counter()
        frames, metrics = TA.run(cfg, num_frames=APP_FRAMES, save_tree=True, device=dev)
        run_s = time.perf_counter() - t0
        launches = {name: f.launches for name, f in counted.items() if f.launches}
        want = {"composite_march_pooled_pair16": APP_FRAMES} if mode == "compositing" else \
            {"iso_march_pooled_narrow": APP_FRAMES, "iso_shade_pooled": APP_FRAMES}
        cam = cfg.render.camera
        if launches != want or len(frames) != APP_FRAMES or \
                not all(f.shape == (cam.height, cam.width, 3) and np.isfinite(f).all()
                        for f in frames):
            raise AssertionError(f"app {mode}: {len(frames)} frames, launches {launches}, "
                                 f"expected {want} and finite (H, W, 3) frames")

        # the same tree from the file run saved: the plain pooled march, the
        # plain path, the frame by events and under the profiler
        tree = KT.open_tree_full(cfg.tree_path)
        renderer = CompressedRenderer(tree, dev)
        rays = generate_rays(cam, device=dev)
        plan_call = TA.frame_renderer(cfg, renderer, rays)
        frame0 = torch.from_numpy(frames[0]).to(dev)
        if not torch.equal(plan_call()[0], frame0):
            raise AssertionError(f"app {mode}: the saved tree's plan renders another frame 0")
        fmt = "pair16" if mode == "compositing" else "narrowf32"
        sampler = slab_pool_sampler(*renderer.slab_pool_at(None, fmt), tree.dims)
        rplan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, tree.dims)
        args = (rplan.entry_uv, rplan.dir_step, rplan.hit.bool())
        plain_cfg = dataclasses.replace(
            cfg, render=dataclasses.replace(cfg.render, use_pallas_kernel=False))
        plain_rgb, plain_aux = TA.frame_renderer(plain_cfg, renderer, rays)()
        n_px = cam.width * cam.height
        allowed = KNIFE_PER_MPX * n_px / 2**20
        if mode == "compositing":
            c_p, a_p = composite_march_steps(sampler, *args, cfg.render.max_samples)
            pooled_equal = bool(torch.equal(apply_reference_transfer(c_p, a_p), frame0))
            d = (frame0 - plain_rgb).abs().amax(dim=-1)
            bars = {"max_abs": float(d.max()), "px_beyond_6e-7": int((d > APP_COMP_BAR).sum()),
                    "px_allowed": allowed}
            ok = bars["px_beyond_6e-7"] <= allowed and bars["max_abs"] <= LOOSE
        else:
            iso = cfg.render.iso_value
            f_p, t_p = iso_march_steps(sampler, *args, iso)
            rgb_p = shade_hits(sampler, *args[:2], rplan.direction, f_p, t_p, iso)
            pooled_equal = bool(torch.equal(rgb_p, frame0))
            found_k = plan_call()[1]
            agree = found_k == plain_aux
            bars = {"px_found_differ": int((~agree).sum()), "px_allowed": allowed,
                    "rgb_max_abs_where_found_agrees": float(
                        ((frame0 - plain_rgb).abs().amax(dim=-1) * agree).max()),
                    "hits": int(found_k.sum())}
            ok = bars["px_found_differ"] <= allowed and \
                bars["rgb_max_abs_where_found_agrees"] <= APP_ISO_BAR
        if not pooled_equal or not ok:
            raise AssertionError(f"app {mode}: frame 0 bit-equal to the plain pooled march "
                                 f"{pooled_equal}; against use_pallas_kernel=False {bars}")
        frame_event_ms = time_ms(plan_call)
        # two frames in the profiled scope after PROFILE_WARM_KERNELS small
        # kernels: on the H100 (torch 2.11), a profiler run that follows GPU
        # work done while nothing was profiled can lose the records of its
        # first kernels, all of them in a scope this small; 300 small kernels
        # first lost 9 of their own and kept the frames
        # (scripts/torch_profiler_probe.py)
        with timed(f"app_{mode}_frames", profile=True, profile_dir=str(work / "trace")) as r:
            scratch = torch.zeros(1, device=dev)
            for _ in range(PROFILE_WARM_KERNELS):
                scratch.add_(1.0)
            for _ in range(2):
                out = plan_call()
            torch.cuda.synchronize()
        kernels = trace_kernels(r["trace_file"])
        march = "composite_march_kernel" if mode == "compositing" else "iso_march_kernel"
        if not any(march in k for k in kernels) or (mode == "isosurface" and not any(
                "iso_shade_kernel" in k for k in kernels)):
            raise AssertionError(f"app {mode}: the profiled frame's trace names no {march}: "
                                 f"{kernels}")
        emit({"phase": "app", "mode": mode, "hw": [cam.height, cam.width],
              "volume": list(cfg.dataset.synthetic_dims), "seed": cfg.dataset.timestep,
              "tolerance": cfg.codec.tolerance, "max_epochs": cfg.codec.max_epochs,
              "frames": APP_FRAMES, "run_s": run_s,
              "build_s": DebugTimer.mean_ms("TOTAL_CONSTRUCTION") / 1e3,
              "load_ms": DebugTimer.mean_ms("LOAD"), "plan_ms": DebugTimer.mean_ms("PLAN"),
              "frame_ms_host_clock": metrics.values["frame_ms"], "frame_ms_events": frame_event_ms,
              "metrics": metrics.values, "launches": launches,
              "frame0_bit_equal_plain_pooled_march": pooled_equal, "vs_plain_path": bars,
              "profiled_frames_s": r["seconds"], "trace_file": os.path.basename(r["trace_file"]),
              "trace_kernels": kernels, "frame_sum": float(out[0].sum()), "gpu": smi})


def run_config5(dev, smi: str, work: Path) -> None:
    """BASELINE config 5 through ``TimestepStreamer``: timesteps 270-273,
    each 8 synthetic turbulence bricks of 128^3 in a 2x2x2 grid (256^3),
    the kd-tree at tolerance 4, 1 epoch, prefetch 2, checkpoints in a cache
    directory; per timestep a 1024^2 render from the brick-sharded layout
    (``render_bricksharded_kernel``, B10 once per brick) and one TF-gradient
    step (``tf_fit_step_bricksharded``, B11 once per brick), the four
    bricks on ``cuda:0``.  Each render lies within the sharded envelope
    (``docs/PARITY.md`` deviation 6) of the unsharded B1 on the same volume;
    the losses are finite.  Then a second pass resumes from the checkpoint
    files: no brick is read, every renderer is a ``CompressedRenderer`` and
    every image equals the first pass's."""
    from volumerenderer_tpu_torch import Camera, TFParams, generate_rays
    from volumerenderer_tpu_torch.io.bricks import BrickGrid, synthetic_brick_source
    from volumerenderer_tpu_torch.io.streaming import TimestepStreamer
    from volumerenderer_tpu_torch.models import CompressedRenderer, plan_compositing
    from volumerenderer_tpu_torch.ops.cuda import seg_kernel as SK
    from volumerenderer_tpu_torch.ops.raycast import ALPHA_SCALE, EARLY_OUT_ALPHA
    from volumerenderer_tpu_torch.parallel import bricks as PB
    from volumerenderer_tpu_torch.parallel import kernel_sharded as KS

    grid = BrickGrid(brick_dims=CONFIG5_BRICK, grid=(2, 2, 2))
    source = synthetic_brick_source(grid)
    reads = []

    def counting(b, t):
        reads.append((b, t))
        return source(b, t)

    rays = generate_rays(Camera(width=W, height=H), device=dev)
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, grid.volume_dims())
    mesh = PB.make_brick_mesh(BRICKS)
    target = torch.full((H, W, 3), 0.5, device=dev)
    tau0 = 1.0 - EARLY_OUT_ALPHA
    bars = {"rgb": tau0 / ALPHA_SCALE + 1e-5, "alpha": tau0 + 1e-5}
    cache = work / "config5"
    cache.mkdir()

    def stream(src):
        return TimestepStreamer(src, grid, CONFIG5_TIMESTEPS, num_bricks=8, I=2, J=2, K_bricks=2,
                                tolerance=CONFIG5_TOLERANCE, max_epochs=1, prefetch=2,
                                cache_dir=str(cache), device=dev)

    params = TFParams.reference(dev)
    images, steps, losses = {}, [], []
    t_start = time.perf_counter()
    t_prev = t_start
    for t, renderer in stream(counting):
        vol = renderer.volume_at()
        SK.seg_march_cuda.launches = 0
        SK.seg_tf_march_cuda.launches = 0
        sv = PB.shard_volume(mesh, vol)
        rgb, alpha = KS.render_bricksharded_kernel(mesh, plan, sv)
        params, loss = KS.tf_fit_step_bricksharded(mesh, plan, params, sv, target, lr=FIT_LR)
        loss = float(loss)
        launches = {"seg_march": SK.seg_march_cuda.launches,
                    "seg_tf_march": SK.seg_tf_march_cuda.launches}
        now = time.perf_counter()
        rgb_d, a_d = plan.render(vol)
        err = {"rgb": float((rgb - rgb_d).abs().max()), "alpha": float((alpha - a_d).abs().max())}
        if launches != {"seg_march": mesh.size, "seg_tf_march": mesh.size} or \
                not math.isfinite(loss) or not bool(torch.isfinite(rgb).all()) or \
                any(err[n] > bars[n] for n in bars) or not isinstance(renderer, CompressedRenderer):
            raise AssertionError(f"config5 timestep {t}: launches {launches}, loss {loss}, "
                                 f"vs unsharded B1 {err} (bars {bars})")
        images[t] = rgb
        losses.append(loss)
        steps.append({"timestep": t, "s": now - t_prev, "launches": launches,
                      "vs_unsharded_b1": err, "loss": loss})
        t_prev = time.perf_counter()
    first_s = time.perf_counter() - t_start
    first_reads = len(reads)
    reads.clear()

    t0 = time.perf_counter()
    resumed = []
    for t, renderer in stream(counting):
        if not isinstance(renderer, CompressedRenderer):
            raise AssertionError(f"config5 resume: timestep {t} came back as "
                                 f"{type(renderer).__name__}")
        sv = PB.shard_volume(mesh, renderer.volume_at())
        rgb, _ = KS.render_bricksharded_kernel(mesh, plan, sv)
        resumed.append(t)
        if not torch.equal(rgb, images[t]):
            raise AssertionError(f"config5 resume: timestep {t} renders another image")
    resume_s = time.perf_counter() - t0
    if reads or resumed != list(CONFIG5_TIMESTEPS) or sorted(images) != resumed:
        raise AssertionError(f"config5 resume: {len(reads)} brick reads, timesteps {resumed}")
    emit({"phase": "config5", "timesteps": list(CONFIG5_TIMESTEPS), "bricks": 8,
          "brick_dims": list(CONFIG5_BRICK), "volume": list(grid.volume_dims()),
          "tolerance": CONFIG5_TOLERANCE, "max_epochs": 1, "prefetch": 2, "hw": [H, W],
          "layout": f"bricks {BRICKS} on {[str(d) for d in mesh.devices.flat]}",
          "brick_reads": first_reads, "total_s": first_s,
          "per_timestep_s": first_s / len(CONFIG5_TIMESTEPS), "steps": steps, "losses": losses,
          "envelope_bars": bars, "resume_s": resume_s, "resume_brick_reads": 0,
          "resume_images_equal": True, "checkpoint_bytes": {
              p.name: p.stat().st_size for p in sorted(cache.iterdir())}, "gpu": smi})


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


def multihost_argv(work: Path) -> list[str]:
    """One rank of the multihost phase: this script with ``--multihost-rank``
    (``multihost.spawn`` appends the coordinator, the count and the rank)."""
    return [sys.executable, "-u", str(HERE / "chip_smoke.py"), "--multihost-rank", str(work)]


def digest(*tensors) -> str:
    """A hash of the tensors' bytes: equal digests, bit-equal tensors."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def local_block(grid, wanted, source, timestep):
    """The bricks ``wanted`` assembled into the box they fill: (block, its
    (z, y, x) offset in the volume)."""
    bx, by, bz = grid.brick_dims
    coords = [grid.brick_coords(b) for b in wanted]
    lo = [min(c[a] for c in coords) for a in range(3)]
    hi = [max(c[a] for c in coords) + 1 for a in range(3)]
    block = np.zeros(((hi[2] - lo[2]) * bz, (hi[1] - lo[1]) * by, (hi[0] - lo[0]) * bx),
                     dtype=np.uint8)
    for b, (i, j, k) in zip(wanted, coords):
        i, j, k = i - lo[0], j - lo[1], k - lo[2]
        block[k * bz:(k + 1) * bz, j * by:(j + 1) * by, i * bx:(i + 1) * bx] = source(b, timestep)
    return block, (lo[2] * bz, lo[1] * by, lo[0] * bx)


def multihost_rank(dev, work: Path, coordinator: str, num_processes: int, process_id: int):
    """One rank of the multihost phase, on ``dev`` (``cuda:0``, shared with
    the other rank): joins the group (gloo: the ranks share the card), reads
    only its bricks, places them on a z4 and a bricks221 mesh over both
    ranks, renders the orbit through B10 on each layout, then row-sharded
    B1 on frame 0 and FIT_STEPS B4 fit steps on a replicated volume, and one
    B11 step; writes its digests, images, parameters, timings, launch
    counts and peak memory to ``work``."""
    from volumerenderer_tpu_torch import TFParams, generate_rays
    from volumerenderer_tpu_torch.io.bricks import BrickGrid, synthetic_brick_source
    from volumerenderer_tpu_torch.models import plan_compositing
    from volumerenderer_tpu_torch.ops.cuda import _build
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.cuda import seg_kernel as SK
    from volumerenderer_tpu_torch.ops.cuda import tf_kernel as TK
    from volumerenderer_tpu_torch.parallel import bricks as PB
    from volumerenderer_tpu_torch.parallel import kernel_sharded as KS
    from volumerenderer_tpu_torch.parallel import multihost as MH

    t_start = time.perf_counter()
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    per_rank = Z_SHARDS // num_processes
    backend = MH.initialize(coordinator, num_processes, process_id, local_devices=[dev] * per_rank)
    rank = MH.process_index()
    # the parent built every kernel: each load finds its library
    built = _build.load_many(["seg_march", "composite_march", "tf_march"])

    # 1. per-host brick I/O: this rank's k-layers for the z mesh, the bricks
    # of its own (bz, by, bx) shards for the bricks mesh
    grid = BrickGrid(brick_dims=CONFIG5_BRICK, grid=(2, 2, 2))
    X, Y, Z = grid.volume_dims()
    source = synthetic_brick_source(grid)
    reads = []

    def counting(b, t):
        reads.append(b)
        return source(b, t)

    mine = MH.host_local_bricks(grid, Z_SHARDS)
    t0 = time.perf_counter()
    slab = MH.load_bricks_for_host(counting, grid, MULTIHOST_TIMESTEP)
    load_s = time.perf_counter() - t0
    zmesh = MH.global_mesh(("z",))
    sv_z = PB.shard_volume(zmesh, torch.from_numpy(slab), offset=(slab.shape[0] * rank, 0, 0))
    z_reads = sorted(reads)
    reads.clear()
    bmesh = MH.global_mesh(("bz", "by", "bx"), shape=BRICKS)
    wanted = sorted({b for i in bmesh.local_indices()
                     for b in PB.host_local_bricks_3d(grid, BRICKS, np.unravel_index(i, BRICKS))})
    block, offset = local_block(grid, wanted, counting, MULTIHOST_TIMESTEP)
    sv_b = PB.shard_volume(bmesh, torch.from_numpy(block), offset=offset)
    b_reads = sorted(reads)
    if z_reads != mine or b_reads != wanted or len(mine) != grid.num_bricks() // num_processes:
        raise AssertionError(f"rank {rank} read bricks {z_reads} and {b_reads}, its own are "
                             f"{mine} and {wanted}")

    # 2, 3. z4 and bricks221 over the orbit, each frame two B10 launches per
    # rank (from its shards' entry tables, built at a camera's first frame)
    # and the gather of the segment maps; every rank returns the full image
    bundles = [generate_rays(orbit_camera(2.0 * i, W, H), device=dev)
               for i in range(N_FRAMES)]
    plans = [plan_compositing(r.entry_uv, r.direction, r.hit, (X, Y, Z)) for r in bundles]
    layouts = {"z4": (zmesh, sv_z, KS.render_zsharded_kernel),
               "bricks221": (bmesh, sv_b, KS.render_bricksharded_kernel)}
    SK.seg_march_cuda.launches = 0
    SK.seg_entry_table_cuda.launches = 0
    renders = dict.fromkeys(layouts, 0)

    def sweep(name):
        mesh, sv, render = layouts[name]
        acc = torch.zeros((), device=dev)
        for plan in plans:
            rgb, _ = render(mesh, plan, sv)
            renders[name] += 1
            acc = acc + rgb.sum()
        return float(acc)

    ms = {name: 1e3 * sweep_seconds(lambda: sweep(name)) / N_FRAMES for name in layouts}
    digests = {}
    for name, (mesh, sv, render) in layouts.items():
        digests[name] = [digest(*render(mesh, plan, sv)) for plan in plans]
        renders[name] += len(plans)
    seg_launches = {"seg_march": SK.seg_march_cuda.launches,
                    "seg_entry_table": SK.seg_entry_table_cuda.launches}

    # the gather's share of a z4 frame: frame 0's segment maps of this
    # rank's shards gathered alone; within it gloo's all_gather of the same
    # bytes between host buffers; and the halo exchange, one small gather
    # (host clock, each ended by a device sync; min of REPS after a warm call)
    plan0 = plans[0]
    outs = [SK.seg_march_cuda(s, plan0.entry_uv.to(s.device), plan0.dir_step.to(s.device),
                              plan0.hit.to(s.device), **kw,
                              starts=KS.shard_starts(plan0, kw, s.device))
            for s, kw in KS.seg_shards(zmesh, plan0, sv_z)]
    host = torch.empty((len(outs), 3 * H * W), dtype=torch.float32)
    received = [torch.empty_like(host) for _ in range(num_processes)]

    def host_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, 1e3 * (time.perf_counter() - t0))
        return best

    gather_ms = {"gather": host_ms(lambda: MH.gather(zmesh, outs)),
                 "gloo_all_gather_host_buffers": host_ms(
                     lambda: torch.distributed.all_gather(received, host)),
                 "halo_exchange": host_ms(lambda: PB.extend_halos(sv_z.bricks, axes=(0,),
                                                                  mesh=zmesh))}

    # 4, 5. the row-sharded paths on the volume replicated from the z slabs
    # (one gather): B1 on frame 0, FIT_STEPS B4 steps; then one B11 step
    full = torch.cat([b for (b,) in MH.gather(zmesh, [(sv_z.bricks[i, 0, 0],)
                                                      for i in zmesh.local_indices()])])
    rmesh = MH.global_mesh()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    target = torch.full((H, W, 3), 0.5, device=dev)
    RK.composite_march_cuda.launches = 0
    TK.tf_march_cuda.launches = 0
    SK.seg_tf_march_cuda.launches = 0
    rgb_r, a_r = KS.render_planned_sharded(rmesh, plan0, full)
    params, losses = TFParams(*(f32(v) for v in NON_REFERENCE_TF)), []
    for _ in range(FIT_STEPS):
        params, loss = KS.tf_fit_step_kernel(rmesh, plan0, params, full, target, lr=FIT_LR)
        losses.append(loss)
    b11_params, b11_loss = KS.tf_fit_step_bricksharded(
        bmesh, plan0, TFParams(*(f32(v) for v in NON_REFERENCE_TF)), sv_b, target, lr=FIT_LR)
    row_launches = {"composite_march": RK.composite_march_cuda.launches,
                    "tf_march": TK.tf_march_cuda.launches,
                    "seg_tf_march": SK.seg_tf_march_cuda.launches}
    rows_ms = 1e3 * sweep_seconds(lambda: float(sum(
        KS.render_planned_sharded(rmesh, p, full)[0].sum() for p in plans))) / N_FRAMES
    probe = KS.scaling_probe_kernel(rmesh, plan0, full)
    np.savez(work / f"rank{rank}.npz", rows_frame0=np.stack([
        rgb_r.cpu().numpy(), np.repeat(a_r.cpu().numpy()[..., None], 3, axis=-1)]),
        tf_losses=np.stack([x.cpu().numpy() for x in losses]),
        **{f"tf_params/{n}": t.cpu().numpy() for n, t in zip(TFParams._fields, params)},
        b11_loss=b11_loss.cpu().numpy(),
        **{f"b11_params/{n}": t.cpu().numpy() for n, t in zip(TFParams._fields, b11_params)})
    (work / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "backend": backend, "devices": [str(dev)] * per_rank,
        "z_mesh_ranks": zmesh.ranks.tolist(), "bricks_mesh_ranks": bmesh.ranks.reshape(-1).tolist(),
        "builds_reused": all(b.build_seconds == 0.0 for b in built.values()),
        "brick_reads": {"z4": z_reads, "bricks221": b_reads}, "brick_load_s": load_s,
        "ms_per_frame": {**ms, "rows": rows_ms}, "renders": renders,
        "z4_gather_ms": gather_ms, "digests": digests,
        "launches": {**seg_launches, **row_launches}, "scaling_probe_kernel": probe,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
        "seconds": time.perf_counter() - t_start}))


def multihost_main(argv) -> int:
    """``chip_smoke.py --multihost-rank <dir> --coordinator A --num-processes
    N --process-id R``: one rank of the multihost phase on ``cuda:0``."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--multihost-rank", type=Path, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: a multihost rank needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import_port()
    multihost_rank(torch.device("cuda", 0), args.multihost_rank, args.coordinator,
                   args.num_processes, args.process_id)
    return 0


def run_multihost(dev, smi: str) -> None:
    """The multi-process layouts: ``MULTIHOST_RANKS`` ranks on ``dev`` over
    gloo (``multihost_rank``), each reading only its bricks of config 5's
    256^3 volume; their z4 and bricks221 orbit renders (B10), row-sharded B1
    frame and B4 fit steps held bit for bit against this process's
    single-process port on the assembled volume, their B11 step within
    tests/test_torch_sharded.py's bar.  A rank that fails fails the phase."""
    from volumerenderer_tpu_torch import TFParams, generate_rays
    from volumerenderer_tpu_torch.io.bricks import BrickGrid, load_bricks, synthetic_brick_source
    from volumerenderer_tpu_torch.models import plan_compositing
    from volumerenderer_tpu_torch.parallel import bricks as PB
    from volumerenderer_tpu_torch.parallel import context as PC
    from volumerenderer_tpu_torch.parallel import kernel_sharded as KS
    from volumerenderer_tpu_torch.parallel import multihost as MH
    from volumerenderer_tpu_torch.parallel import sharding as PS

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as work:
        MH.spawn(multihost_argv(Path(work)), MULTIHOST_RANKS, MULTIHOST_TIMEOUT_S)
        ranks = [json.loads((Path(work) / f"rank{r}.json").read_text())
                 for r in range(MULTIHOST_RANKS)]
        arrays = [dict(np.load(Path(work) / f"rank{r}.npz")) for r in range(MULTIHOST_RANKS)]
    ranks_s = time.perf_counter() - t0

    # the single-process port on the assembled volume, the same cameras
    grid = BrickGrid(brick_dims=CONFIG5_BRICK, grid=(2, 2, 2))
    X, Y, Z = grid.volume_dims()
    full = torch.from_numpy(load_bricks(synthetic_brick_source(grid), grid, grid.num_bricks(),
                                        *grid.grid, MULTIHOST_TIMESTEP)).to(dev)
    bundles = [generate_rays(orbit_camera(2.0 * i, W, H), device=dev)
               for i in range(N_FRAMES)]
    plans = [plan_compositing(r.entry_uv, r.direction, r.hit, (X, Y, Z)) for r in bundles]
    zmesh, bmesh = PC.make_z_mesh(Z_SHARDS), PB.make_brick_mesh(BRICKS)
    layouts = {"z4": (zmesh, PB.shard_volume(zmesh, full), KS.render_zsharded_kernel),
               "bricks221": (bmesh, PB.shard_volume(bmesh, full), KS.render_bricksharded_kernel)}
    want = {name: [digest(*render(mesh, plan, sv)) for plan in plans]
            for name, (mesh, sv, render) in layouts.items()}

    def sweep(name):
        mesh, sv, render = layouts[name]
        return float(sum(render(mesh, plan, sv)[0].sum() for plan in plans))

    single_ms = {name: 1e3 * sweep_seconds(lambda: sweep(name)) / N_FRAMES for name in layouts}
    rmesh, plan0 = PS.make_mesh(Z_SHARDS), plans[0]
    single_ms["rows"] = 1e3 * sweep_seconds(lambda: float(sum(
        KS.render_planned_sharded(rmesh, p, full)[0].sum() for p in plans))) / N_FRAMES
    rgb_r, a_r = KS.render_planned_sharded(rmesh, plan0, full)
    rows_frame0 = np.stack([rgb_r.cpu().numpy(), np.repeat(a_r.cpu().numpy()[..., None], 3, -1)])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    target = torch.full((H, W, 3), 0.5, device=dev)
    params, losses = TFParams(*(f32(v) for v in NON_REFERENCE_TF)), []
    for _ in range(FIT_STEPS):
        params, loss = KS.tf_fit_step_kernel(rmesh, plan0, params, full, target, lr=FIT_LR)
        losses.append(loss)
    b11_params, b11_loss = KS.tf_fit_step_bricksharded(
        bmesh, plan0, TFParams(*(f32(v) for v in NON_REFERENCE_TF)), layouts["bricks221"][1],
        target, lr=FIT_LR)

    per_rank = Z_SHARDS // MULTIHOST_RANKS
    want_launches = {"seg_march": per_rank * sum(ranks[0]["renders"].values()),
                     "seg_entry_table": per_rank * N_FRAMES * len(layouts),
                     "composite_march": per_rank, "tf_march": per_rank * FIT_STEPS,
                     "seg_tf_march": per_rank}
    checks = []
    for info, arr in zip(ranks, arrays):
        r = info["rank"]
        b11_loss_rel = abs(float(arr["b11_loss"]) - float(b11_loss)) / abs(float(b11_loss))
        b11_param_err = {n: float((np.abs(arr[f"b11_params/{n}"] - t.cpu().numpy())
                                   - B11_PARAM_RTOL * np.abs(t.cpu().numpy())).max())
                         for n, t in zip(TFParams._fields, b11_params)}
        check = {
            "rank": r, "backend": info["backend"],
            "frames_differ": {name: [i for i, (a, b) in enumerate(zip(info["digests"][name],
                                                                      want[name])) if a != b]
                              for name in layouts},
            "rows_frame0_bit_equal": np.array_equal(arr["rows_frame0"], rows_frame0),
            "tf_losses_bit_equal": np.array_equal(
                arr["tf_losses"], np.stack([x.cpu().numpy() for x in losses])),
            "tf_params_bit_equal": all(np.array_equal(arr[f"tf_params/{n}"], t.cpu().numpy())
                                       for n, t in zip(TFParams._fields, params)),
            "b11_bit_equal": float(arr["b11_loss"]) == float(b11_loss) and all(
                np.array_equal(arr[f"b11_params/{n}"], t.cpu().numpy())
                for n, t in zip(TFParams._fields, b11_params)),
            "b11_loss_rel_err": b11_loss_rel, "b11_param_err_beyond_rtol": b11_param_err,
            "launches": info["launches"]}
        if info["backend"] != "gloo" or any(check["frames_differ"].values()) \
                or not (check["rows_frame0_bit_equal"] and check["tf_losses_bit_equal"]
                        and check["tf_params_bit_equal"]) \
                or b11_loss_rel > B11_LOSS_RTOL or max(b11_param_err.values()) > B11_PARAM_ATOL \
                or info["launches"] != want_launches or info["renders"] != ranks[0]["renders"]:
            raise AssertionError(f"multihost rank {r} against the single-process port: {check}; "
                                 f"launches wanted {want_launches}")
        checks.append(check)
    z4_ms = [info["ms_per_frame"]["z4"] for info in ranks]
    emit({"phase": "multihost", "ranks": MULTIHOST_RANKS, "backend": ranks[0]["backend"],
          "collectives": "gloo all_gather over TCP on the host; CUDA tensors staged through "
                         "pinned host buffers",
          "device_per_rank": ranks[0]["devices"], "z_mesh_ranks": ranks[0]["z_mesh_ranks"],
          "bricks_mesh_ranks": ranks[0]["bricks_mesh_ranks"], "volume": [Z, Y, X],
          "brick_dims": list(CONFIG5_BRICK), "timestep": MULTIHOST_TIMESTEP, "hw": [H, W],
          "frames": N_FRAMES, "brick_reads": [info["brick_reads"] for info in ranks],
          "ms_per_frame": [info["ms_per_frame"] for info in ranks],
          "single_process_ms_per_frame": single_ms,
          "z4_gather_ms": [info["z4_gather_ms"] for info in ranks],
          "z4_gather_share": [g["z4_gather_ms"]["gather"] / m for g, m in zip(ranks, z4_ms)],
          "peak_memory_bytes": [info["peak_memory_bytes"] for info in ranks],
          "scaling_probe_kernel": [info["scaling_probe_kernel"] for info in ranks],
          "builds_reused": [info["builds_reused"] for info in ranks],
          "rank_seconds": [info["seconds"] for info in ranks], "phase_seconds":
          time.perf_counter() - t0, "ranks_wall_s": ranks_s, "checks": checks,
          "launches_per_rank": want_launches, "tf_losses": [float(x) for x in losses],
          "gpu": smi})


def port_script(name: str):
    """A script of the port's ``scripts/`` directory, imported as a module."""
    import importlib

    if str(HERE / "scripts") not in sys.path:
        sys.path.insert(0, str(HERE / "scripts"))
    return importlib.import_module(name)


def run_entry(dev, smi: str) -> None:
    """``entry()`` on the card: one launch of B1 per call, its rgb bit-equal to
    the transfer of the plain march of the same plan's tensors."""
    from volumerenderer_tpu_torch import entry as TE
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.raycast import apply_reference_transfer, composite_march_steps
    from volumerenderer_tpu_torch.ops.sampling import as_normalized_volume

    fn, args = TE.entry()
    RK.composite_march_cuda.f32_launches = 0
    rgb = fn(*args)
    torch.cuda.synchronize()
    launches = RK.composite_march_cuda.f32_launches
    vol, entry_uv, dir_step, hit = args
    vol_plain = as_normalized_volume(RK.quantize_u8(vol))

    def plain():
        c, a = composite_march_steps(vol_plain, entry_uv, dir_step, hit.bool())
        return apply_reference_transfer(c, a)

    equal = bool(torch.equal(rgb, plain()))
    if launches != 1 or not equal or tuple(rgb.shape) != tuple(hit.shape) + (3,) \
            or not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"entry(): {launches} launches of B1 (expected 1), rgb "
                             f"{tuple(rgb.shape)} bit-equal to the plain march: {equal}")
    emit({"phase": "entry", "shape": list(rgb.shape), "volume": list(vol.shape),
          "launches": {"composite_march_f32": launches}, "bit_equal_plain": equal,
          "ms_per_call": time_ms(lambda: fn(*args)), "plain_ms": time_ms(plain),
          "sum_rgb": float(rgb.sum()), "gpu": smi})


def run_rm_smoke(dev, smi: str, work: Path) -> None:
    """The RM smoke test (``scripts/torch_rm_smoke.py``) on 8 synthetic
    turbulence bricks of the RM brick size, written in the RM layout: its
    steps through the functions its ``main`` calls, then ``main`` itself, a
    deleted brick (rc 1) and a brick one byte short (``ValueError``)."""
    from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.io.bricks import load_bricks, rm_brick_path, synthetic_brick_source
    from volumerenderer_tpu_torch.models import plan_compositing
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.raycast import apply_reference_transfer, composite_march_steps

    smoke = port_script("torch_rm_smoke")
    t_phase = time.perf_counter()
    steps = {}
    grid, top = smoke.RM_GRID, work / "rm"
    (top / f"bob{RM_TIMESTEP:03d}").mkdir(parents=True)
    t0 = time.perf_counter()
    source = synthetic_brick_source(grid)
    bricks = [source(b, RM_TIMESTEP) for b in range(RM_BRICKS)]
    for b, data in enumerate(bricks):
        data.tofile(rm_brick_path(str(top), b, RM_TIMESTEP))
    steps["write_bricks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    missing = smoke.discover(str(top), RM_BRICKS, RM_TIMESTEP)
    steps["discover"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ijk = smoke.parse_grid(RM_GRID_TEXT, RM_BRICKS)
    vol = smoke.assemble(str(top), RM_BRICKS, ijk, RM_TIMESTEP, grid)
    crc = smoke.volume_crc32(vol)
    steps["assemble_crc32"] = time.perf_counter() - t0
    crc_memory = smoke.volume_crc32(load_bricks(lambda b, t: bricks[b], grid, RM_BRICKS, *ijk,
                                                RM_TIMESTEP))
    X, Y, Z = grid.volume_dims(*ijk)
    if missing or crc != crc_memory or vol.shape != (Z, Y, X):
        raise AssertionError(f"rm_smoke: missing {missing}, CRC32 {crc:#010x} against the "
                             f"in-memory assembly's {crc_memory:#010x}, shape {vol.shape}")
    t0 = time.perf_counter()
    codec = smoke.codec_round_trip(vol)
    steps["codec"] = time.perf_counter() - t0

    # the 1024^2 frame through B1, bit-equal to the plain march on the card
    t0 = time.perf_counter()
    RK.composite_march_cuda.f32_launches = 0
    rgb, alpha = smoke.render_frame(vol, dev, smoke.FRAME_SIZE)
    torch.cuda.synchronize()
    launches = RK.composite_march_cuda.f32_launches
    steps["render_frame"] = time.perf_counter() - t0
    nv = as_normalized_volume(vol, device=dev)
    rays = generate_rays(Camera(width=smoke.FRAME_SIZE, height=smoke.FRAME_SIZE), device=dev)
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))

    def plain():
        c, a = composite_march_steps(nv, plan.entry_uv, plan.dir_step, plan.hit.bool())
        return apply_reference_transfer(c, a), a

    rgb_p, alpha_p = plain()
    equal = bool(torch.equal(rgb, rgb_p) and torch.equal(alpha, alpha_p))
    if launches != 1 or not equal or not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"rm_smoke frame: {launches} launches of B1 (expected 1), "
                             f"bit-equal to the plain march: {equal}")
    frame_ms, plain_ms = time_ms(lambda: plan.render(nv)), time_ms(plain)

    # main as a user runs it, then its two failure cases
    out = work / "rm_out"
    t0 = time.perf_counter()
    rc = smoke.main(["--rm-dir", str(top), "--no-codec", "--render", "--out", str(out)])
    steps["main_no_codec"] = time.perf_counter() - t0
    if rc != 0 or not np.array_equal(np.load(out / "rm_frame.npy"), rgb.cpu().numpy()):
        raise AssertionError(f"rm_smoke main: rc {rc}, or its rm_frame.npy differs")
    path = Path(rm_brick_path(str(top), 5, RM_TIMESTEP))
    with open(path, "r+b") as f:
        f.truncate(path.stat().st_size - 1)
    try:
        smoke.main(["--rm-dir", str(top), "--no-codec"])
        short = "no error"
    except ValueError as exc:
        short = str(exc)
    path.unlink()
    rc_missing = smoke.main(["--rm-dir", str(top), "--no-codec"])
    if "File size does not match" not in short or rc_missing != 1:
        raise AssertionError(f"rm_smoke failure cases: a short brick gave {short!r}, a "
                             f"deleted one rc {rc_missing}")
    emit({"phase": "rm_smoke", "bricks": RM_BRICKS, "brick_dims": list(grid.brick_dims),
          "grid": list(ijk), "volume_zyx": list(vol.shape), "found": RM_BRICKS - len(missing),
          "crc32": f"{crc:#010x}", "crc32_in_memory": f"{crc_memory:#010x}",
          "min": int(vol.min()), "max": int(vol.max()), "mean": float(vol.mean()),
          "codec": codec, "frame": {"shape": list(rgb.shape),
                                    "launches": {"composite_march_f32": launches},
                                    "bit_equal_plain": equal, "ms": frame_ms,
                                    "plain_ms": plain_ms},
          "short_brick": short, "rc_missing": rc_missing, "seconds_per_step": steps,
          "seconds": time.perf_counter() - t_phase, "gpu": smi})


def run_render_demo(dev, smi: str, work: Path) -> None:
    """The render demo (``scripts/torch_render_demo.py``) at its defaults:
    ``main`` on the card (B1 for the compositing and error images, B2 and B3
    for the isosurface, B7 for both compressed cuts), each image held against
    its plain version on the card and its PNG read back."""
    from volumerenderer_tpu_torch.models import best_isosurface_renderer
    from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.isosurface import render_isosurface

    demo = port_script("torch_render_demo")
    wrappers = {"composite_march": RK.composite_march_cuda,
                "iso_march": IK.iso_march_cuda, "iso_shade": IK.iso_shade_cuda,
                "composite_march_pooled_pair16": RK.composite_march_pooled_pair16_cuda}
    expected = {"composite_march": 2, "iso_march": 1, "iso_shade": 1,
                "composite_march_pooled_pair16": 2}
    out = work / "demo"
    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    images, build_s = demo.main(out_dir=str(out), device="cuda")
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    main_s = time.perf_counter() - t0
    if launches != expected:
        raise AssertionError(f"render_demo launched {launches}, expected {expected}")

    vol_u8, vol, rays = demo.demo_inputs(DEMO_SIZE, DEMO_DIMS, dev)
    tree, _ = demo.build_tree(vol_u8)
    plain = demo.renders(vol_u8, vol, rays, tree, plain=True)
    kernel = demo.renders(vol_u8, vol, rays, tree)
    per_image, failed = {}, []
    for name in demo.IMAGES:
        got = images[name]
        png_equal = bool(np.array_equal(demo.read_png(str(out / f"{name}.png")),
                                        demo.to_uint8(got)))
        row = {"ms": time_ms(kernel[name]), "plain_ms": time_ms(plain[name]),
               "png_read_back_equal": png_equal}
        if name == "isosurface":
            # docs/PARITY.md's iso bar: found equal on all but 4 px per
            # Mpixel, rgb within 1e-4 elsewhere; the uint8 image may differ
            # by 1 level (a rounding edge) outside those px
            rgb_k, found_k = best_isosurface_renderer()(vol, rays.entry_uv, rays.direction,
                                                        rays.hit, demo.ISO_VALUE)
            rgb_p, found_p = render_isosurface(vol, rays.entry_uv, rays.direction, rays.hit,
                                               demo.ISO_VALUE)
            off = (found_k != found_p) | ((rgb_k - rgb_p).abs().amax(dim=-1) > ISO_RGB_TOL)
            levels = np.abs(demo.to_uint8(got).astype(np.int16)
                            - demo.to_uint8(rgb_p).astype(np.int16)).max(axis=-1)
            allowed = KNIFE_PER_MPX * DEMO_SIZE * DEMO_SIZE / 2**20
            n_off = int(off.sum())
            within = levels[~off.cpu().numpy()]
            row.update({"main_equals_renderer": bool(torch.equal(got, rgb_k)),
                        "hits_kernel": int(found_k.sum()), "hits_plain": int(found_p.sum()),
                        "px_off_bar": n_off, "px_allowed": allowed,
                        "rgb_max_abs_err": float((rgb_k - rgb_p).abs().max()),
                        "u8_max_levels_elsewhere": int(within.max()) if within.size else 0,
                        "u8_px_differ": int((levels > 0).sum())})
            ok = row["main_equals_renderer"] and n_off <= allowed \
                and row["u8_max_levels_elsewhere"] <= 1
        else:
            row["bit_equal_plain"] = ok = bool(torch.equal(got, plain[name]()))
        if not (ok and png_equal):
            failed.append(name)
        per_image[name] = row
    if failed:
        raise AssertionError(f"render_demo: {failed} off their plain versions or PNGs: "
                             f"{per_image}")
    emit({"phase": "render_demo", "size": DEMO_SIZE, "volume": list(DEMO_DIMS),
          "launches": launches, "tree_build_s": build_s, "tree_depth": int(tree.orig_depth),
          "main_s": main_s, "images": per_image, "gpu": smi})


def run_bench(dev, smi: str, turb, bundles) -> None:
    """The port's bench as a user runs it, ``python3 -m
    volumerenderer_tpu_torch.bench`` in a process of its own: rc 0, and
    ``bench.py``'s five metric lines in its order, the headline last, each
    with ``bench.py``'s four keys and a finite positive value.  Each sweep's
    scalar is held against the plain versions' sums over the same orbit on
    this card: compositing, both pools and the forward frame bit for bit,
    the isosurface and the voxel step within the bars derived below.  Each
    metric's counted sweeps launched one B1, B6 or B7 per frame, one B2 and
    one B3 per isosurface frame, one B4 and one B5 per step, and nothing
    else.  The bench's numbers stand beside the main paths' of this run."""
    from volumerenderer_tpu_torch import TFParams, as_normalized_volume
    from volumerenderer_tpu_torch.diff import closed_form as CF
    from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.ops.isosurface import render_isosurface
    from volumerenderer_tpu_torch.ops.raycast import apply_reference_transfer, composite_march_steps

    t0 = time.perf_counter()
    proc = subprocess.run(BENCH_COMMAND, cwd=HERE, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    bench_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench: rc {proc.returncode}\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    metrics = {m["metric"]: m for m in (json.loads(ln) for ln in lines if not ln.startswith("#"))}
    notes = [json.loads(ln[2:]) for ln in lines if ln.startswith("# {")]
    facts = {n["metric"]: n for n in notes if "metric" in n}
    iso_m, narrow_m, pair16_m, voxel_m, head_m = BENCH_METRICS
    if tuple(metrics) != BENCH_METRICS or json.loads(lines[-1])["metric"] != head_m \
            or notes[0].get("gpu") != smi or set(facts) != set(BENCH_METRICS):
        raise AssertionError(f"bench: metric lines {list(metrics)}, last line {lines[-1]!r}, "
                             f"first note {notes[0]}; expected {BENCH_METRICS} after the card "
                             f"{smi!r}")
    for name, m in metrics.items():
        voxel = name == voxel_m
        if set(m) != {"metric", "value", "unit", "vs_baseline"} \
                or not (math.isfinite(m["value"]) and m["value"] > 0) \
                or m["unit"] != ("forward-frames/step" if voxel else "rays/s") \
                or m["vs_baseline"] != (3.0 / m["value"] if voxel else m["value"] / 1e8):
            raise AssertionError(f"bench: metric line {m}")

    # the plain versions' sums, summed in the bench's order: the compositing
    # march on the volume's bytes and the transfer (B1 = B6 = B7 = plain, bit
    # for bit), the plain isosurface render at the median
    plans = [RK.CompositingPlan(r.entry_uv, r.direction, r.hit, VOLUME[::-1]) for r in bundles]
    turb_plain = as_normalized_volume(RK.quantize_u8(turb))
    acc, frame_sums = torch.zeros((), device=dev), []
    for p in plans:
        c, a = composite_march_steps(turb_plain, p.entry_uv, p.dir_step, p.hit.bool(),
                                     p.max_samples)
        frame_sums.append(apply_reference_transfer(c, a).sum())
        acc = acc + frame_sums[-1]
    plain_comp, frame0 = float(acc), float(frame_sums[0])
    iso = IK.volume_median(turb)
    acc = torch.zeros((), device=dev)
    for r in bundles:
        acc = acc + render_isosurface(turb, r.entry_uv, r.direction, r.hit, iso)[0].sum()
    plain_iso = float(acc)
    # a pixel whose found/t_hit differs (KNIFE_PER_MPX per Mpixel) moves its
    # three channels by at most 1 each, every other value by ISO_RGB_TOL
    iso_bar = N_FRAMES * 3 * (KNIFE_PER_MPX * W * H / 2**20 + ISO_RGB_TOL * W * H)

    # the plain voxel step on orbit frame 0 (the TF march, the closed-form
    # gradients, the plain scatter of every alive step's g_s).  Its bar: the
    # kernel's and the plain Σ g_vol each lie within VG_CONSERVATION Σ|g_s|
    # of Σ g_s (vg_parity's conservation bar), and d alpha_scale sums per
    # pixel gaT R - gc (P_total R - QP), whose B4 sums each lie within
    # TF_SUMS_REL of max(1, |plain|)
    reference = TFParams.reference(dev)
    p0 = plans[0]
    tf = CF.tf_scalars(reference)
    args = (turb_plain, p0.entry_uv, p0.dir_step, p0.hit.bool(), tf)
    partials = CF.tf_march_steps(*args)
    rgb = (reference.flip_sign * partials[0][..., None] + reference.flip_bias).requires_grad_(True)
    target = torch.full((H, W, 3), 0.5, device=dev)
    (g_rgb,) = torch.autograd.grad(torch.mean((rgb - target) ** 2), [rgb])
    gc, gaT = CF.cotangent_images(reference, g_rgb, None, partials[1])
    g_alpha = CF.tf_param_grads(reference, partials, g_rgb, gc, gaT).alpha_scale
    g_vol = CF.voxel_grad_steps(*args, gc, gaT, partials[3])
    plain_step = float(g_alpha + g_vol.sum())
    gs_abs = sum(float(g_s.double().abs().sum())
                 for _, g_s in CF.step_cotangents(*args, gc, gaT, partials[3]))
    _, _, R, P_tot, QP, _, _ = partials
    scale = torch.stack([R.abs(), (P_tot * R).abs(), QP.abs()]).amax(0).clamp(min=1.0)
    step_bar = (2 * VG_CONSERVATION * gs_abs
                + TF_SUMS_REL * float(((gaT.abs() + 2 * gc.abs()) * scale).sum()))

    frame, step = facts[voxel_m]["forward_frame"], facts[voxel_m]["step"]
    sums = {
        head_m: (facts[head_m]["sweep_sum"], plain_comp, 0.0),
        narrow_m: (facts[narrow_m]["sweep_sum"], plain_comp, 0.0),
        pair16_m: (facts[pair16_m]["sweep_sum"], plain_comp, 0.0),
        "forward_frame": (frame["sweep_sum"], frame0, 0.0),
        iso_m: (facts[iso_m]["sweep_sum"], plain_iso, iso_bar),
        "voxel_step": (step["sweep_sum"], plain_step, step_bar)}
    bad = {k: v for k, v in sums.items() if not abs(v[0] - v[1]) <= v[2]}
    if bad or facts[iso_m]["iso"] != iso or iso != BENCH_ISO:
        raise AssertionError(f"bench: (printed, plain, bar) of the sums off their bars {bad}; "
                             f"isovalue printed {facts[iso_m]['iso']}, here {iso}, recorded "
                             f"{BENCH_ISO}")
    parts = {iso_m: (facts[iso_m], ("iso_march", "iso_shade"), N_FRAMES),
             narrow_m: (facts[narrow_m], ("composite_march_pooled_narrow",), N_FRAMES),
             pair16_m: (facts[pair16_m], ("composite_march_pooled_pair16",), N_FRAMES),
             "forward_frame": (frame, ("composite_march",), 1),
             "voxel_step": (step, ("tf_march", "voxel_grad"), 1),
             head_m: (facts[head_m], ("composite_march",), N_FRAMES)}
    for name, (part, kernels, frames) in parts.items():
        want = {k: (frames * (REPS + 1) if k in kernels else 0) for k in part["launches"]}
        if part["launches"] != want or not set(kernels) <= set(want) \
                or part["renders"] != frames * (REPS + 1) \
                or not part["event_ms_per_frame"] > 0:
            raise AssertionError(f"bench {name}: launches {part['launches']}, expected {want}; "
                                 f"renders {part['renders']}, card ms "
                                 f"{part['event_ms_per_frame']}")

    smoke = {iso_m: PHASES["iso_main_path"]["kernel_rays_per_s"],
             narrow_m: PHASES["pooled_main_path"][narrow_m],
             pair16_m: PHASES["pooled_main_path"][pair16_m],
             voxel_m: PHASES["grad_main_path"]["value"],
             head_m: PHASES["main_path"]["kernel_rays_per_s"]}
    emit({"phase": "bench", "seconds": bench_s, "gpu": smi,
          "metrics": {k: m["value"] for k, m in metrics.items()},
          "host_ms_per_frame": {k: p["host_ms_per_frame"] for k, (p, _, _) in parts.items()},
          "event_ms_per_frame": {k: p["event_ms_per_frame"] for k, (p, _, _) in parts.items()},
          "launches": {k: p["launches"] for k, (p, _, _) in parts.items()},
          "sums_printed_plain_bar": sums, "iso": iso,
          "beside_main_paths": {k: {"bench": metrics[k]["value"], "main_path": v,
                                    "ratio": metrics[k]["value"] / v,
                                    "within_15_percent":
                                        abs(metrics[k]["value"] / v - 1) <= BENCH_AGREEMENT}
                                for k, v in smoke.items()}})


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
    from volumerenderer_tpu_torch.ops.cuda import blockgrid_kernel as GK
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
    _build.load_many(["composite_march", "iso_march", "iso_shade", "block_grid", "tf_march",
                      "voxel_grad", "kdtree_seed", "seg_march", "hashed_build", "kdtree_native"])
    libraries = {"composite_march": RK.load_kernel(), **IK.load_kernels(),
                 "block_grid": GK.load_kernel(),
                 "tf_march": TK.load_kernel(), "voxel_grad": VK.load_kernel(),
                 "kdtree_seed": _build.load("kdtree_seed"), "seg_march": SK.load_kernel(),
                 "hashed_build": _build.load("hashed_build"),
                 "kdtree_native": _build.load("kdtree_native")}
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
             ("orbit_frame0", turb, orbit_camera(0.0, W, H), "clamp"),
             ("orbit_frame15", turb, orbit_camera(2.0 * (N_FRAMES - 1), W, H), "clamp"),
             ("repeat_128", turb, orbit_camera(30.0, 128, 128), "repeat"),
             ("adversarial_frame0", adversarial, orbit_camera(0.0, W, H), "clamp"),
             ("adversarial_repeat_128", adversarial, orbit_camera(30.0, 128, 128),
              "repeat")]
    max_abs_err = 0.0
    for name, v, cam, wrap in cases:
        rays = generate_rays(cam, device=dev)
        Z, Y, X = v.shape
        plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), wrap=wrap)
        vol_u8 = RK.quantize_u8(v)
        args = (plan.entry_uv, plan.dir_step, plan.hit, plan.max_samples, wrap)
        rgb_k, a_k = RK.composite_march_cuda(v, *args)
        rgb_b, a_b = RK.composite_march_cuda(vol_u8, *args)
        c_p, a_p = composite_march_steps(as_normalized_volume(vol_u8), plan.entry_uv,
                                         plan.dir_step, plan.hit.bool(), plan.max_samples, wrap)
        rgb_p = apply_reference_transfer(c_p, a_p)
        torch.cuda.synchronize()
        equal = {"fused_vs_plain": torch.equal(rgb_k, rgb_p) and torch.equal(a_k, a_p),
                 "byte_route_vs_plain": torch.equal(rgb_b, rgb_p) and torch.equal(a_b, a_p),
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
    RK.composite_march_cuda.launches = RK.composite_march_cuda.f32_launches = 0
    renders = 0
    cameras = [orbit_camera(2.0 * i, W, H) for i in range(N_FRAMES)]
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
    launches = RK.composite_march_cuda.f32_launches
    byte_launches = RK.composite_march_cuda.launches - launches
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
        return RK.composite_march_cuda(v, p.entry_uv, p.dir_step, p.hit)

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

    def byte_route_frame():
        return RK.composite_march_cuda(RK.quantize_u8(turb), plan0.entry_uv, plan0.dir_step,
                                       plan0.hit)

    emit({"phase": "layers", "ms": {
        "generate_rays": time_ms(lambda: generate_rays(cam0, device=dev)),
        "plan": time_ms(lambda: plan_compositing(rays0.entry_uv, rays0.direction, rays0.hit,
                                                 VOLUME[::-1])),
        "frame_one_launch": time_ms(lambda: plan0.render(turb)),
        "byte_route_frame": time_ms(byte_route_frame),
        "byte_route_quantize_u8": time_ms(lambda: RK.quantize_u8(turb)),
        "byte_route_march": time_ms(lambda: RK.composite_march_cuda(
            turb_u8, plan0.entry_uv, plan0.dir_step, plan0.hit))},
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
          "byte_route_march_bound_ms": bound(touched + rays_io + RGBA_BYTES * W * H,
                                             OPS_PER_STEP["composite"] * samples, samples,
                                             W * H)["bound_ms"]}
    run_routes(dev, smi, turb, plans)

    iso_kernels, grid_launches = run_isosurface(dev, smi, turb, sphere, cameras, bundles,
                                                adversarial)
    iso_kernels.append(run_grid(dev, smi, turb, grid_launches))
    grad_kernels = run_gradients(dev, smi, turb, sphere, cameras, bundles, samples, touched,
                                 adversarial)
    pooled_kernels, tree, source, tree_build_s = run_compressed(
        dev, smi, turb, sphere, cameras, bundles, {k["name"]: k for k in (b1, *iso_kernels)},
        samples)
    bind_kernels = run_composite_bind(dev, smi, turb, sphere, bundles)
    run_skip_empty(dev, smi, tree, turb, bundles)
    run_diff_finetune(dev, smi, tree, turb, bundles)
    run_midrange(dev, smi, source, tree, bundles)
    run_config4(dev, smi)
    run_device_build(dev, smi, source, tree, tree_build_s, bundles)
    run_octree(dev, smi, source, bundles)
    sharded_kernels = run_sharded(dev, smi, turb, sphere, cameras, bundles)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        run_checkpoint(dev, smi, tree, source, Path(work))
        run_app(dev, smi, Path(work))
        run_config5(dev, smi, Path(work))
    run_multihost(dev, smi)
    run_entry(dev, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        run_rm_smoke(dev, smi, Path(work))
        run_render_demo(dev, smi, Path(work))
    run_bench(dev, smi, turb, bundles)

    emit({"kernels": [b1, *iso_kernels, *grad_kernels, *pooled_kernels, *bind_kernels,
                      *sharded_kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(multihost_main(sys.argv[1:]) if "--multihost-rank" in sys.argv else main())
