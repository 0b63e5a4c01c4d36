"""The port's benchmark: ``bench.py``'s five metrics, measured through the
port on one NVIDIA GPU.

Run from the root of a checkout::

    python3 -m volumerenderer_tpu_torch.bench

It prints one JSON line per metric (the keys ``metric``, ``value``,
``unit``, ``vs_baseline``), in ``bench.py``'s order, the headline last:

* ``iso_rays_per_s_per_chip_1024sq_256cube``: the isosurface at the
  volume's median, each plan bound once before the sweep; a frame is one
  bound march (B2, ``csrc/iso_march.cu``) and one shade (B3,
  ``csrc/iso_shade.cu``);
* ``pooled_rays_per_s_per_chip_1024sq_256cube``: compositing from the
  narrow slab pool, one B6 launch a frame;
* ``pooled_pair16_rays_per_s_per_chip_1024sq_256cube``: from the pair16
  pool, one B7 launch a frame (both ``csrc/composite_march.cu``);
* ``voxelgrad_step_frames_1024sq_256cube``: one voxel-gradient step (the TF
  march B4 forward, the voxel-gradient march B5 in its backward, the MSE
  against a 0.5 gray) over one forward frame (B1), orbit frame 0; lower is
  better;
* ``rays_per_s_per_chip_1024sq_256cube``, the headline: compositing, one B1
  launch a frame.

The protocol is ``bench.py``'s: a 16-frame orbit (``orbit_camera(2.0 *
i)``) of 1024^2 rays over the 256^3 ``turbulence_volume(seed=0)``, one plan
per camera made before any timing, each sweep adding every frame's
``rgb.sum()`` into one scalar on the device that the host reads once at the
sweep's end; the min of 3 sweeps after a warm one (which also builds the
kernels at first use), by the host clock, over the frames a sweep renders.
JAX compiles a sweep into one program; here a sweep is the Python loop of
its renders, so the host's cost per render is in every number, as it is in
a user's frame.  ``vs_baseline`` is against a nominal 1e8 rays/s, and for
the voxel metric ``3.0 / value`` (the goal: a step within 3 forward
frames).

Lines starting with ``#`` come before the metric lines: first one JSON
object with the card's name and power limit as ``nvidia-smi`` gives them,
then, before each metric line, one with the ms per frame by the host clock
and by CUDA events (the card's own time, :func:`time_ms`), the sweep's
scalar, and the launches of each kernel of :data:`KERNELS` over the
host-clock sweeps (the wrappers' ``.launches``).  A secondary metric that
fails prints ``# <name> bench failed: <repr>`` and does not stop the
headline; the command then exits 1.

``bench.py`` reports the pair16 pool alone where the TPU plan has no narrow
word table (``xwords``, ``bench.py:219-222``).  That is a limit of the TPU
kernel; the port has none, so both pooled lines are always printed.

Without a CUDA device the command exits 1 before any metric line; it never
falls back to the CPU.  ``run(device="cpu", ...)`` at small sizes is for
tests: its times are the CPU's, and the card's time is "not measured".
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

import torch

from .camera import Camera, generate_rays
from .diff.transfer import TFParams
from .io.synthetic import turbulence_volume
from .models import plan_compositing
from .ops.cuda import _build
from .ops.cuda import isosurface_kernel as IK
from .ops.cuda import raycast_kernel as RK
from .ops.cuda import tf_kernel as TK
from .ops.cuda import voxel_grad_kernel as VK
from .ops.sampling import as_normalized_volume

__all__ = ["orbit_camera", "time_sweep", "time_ms", "sleep_cycles_per_ms", "nvidia_smi", "emit",
           "sweep_isosurface", "sweep_pooled", "sweep_compositing", "forward_frame",
           "voxel_grad_step", "bench_isosurface", "bench_pooled", "bench_voxel_grad",
           "bench_compositing", "run", "main"]

NOMINAL_BASELINE_RAYS_PER_S = 1.0e8
N_FRAMES = 16
REPS = 3
W = H = 1024
VOLUME = (256, 256, 256)
ISO_METRIC = "iso_rays_per_s_per_chip_1024sq_256cube"
POOLED_METRICS = {"narrow": "pooled_rays_per_s_per_chip_1024sq_256cube",
                  "pair16": "pooled_pair16_rays_per_s_per_chip_1024sq_256cube"}
VOXEL_METRIC = "voxelgrad_step_frames_1024sq_256cube"
HEADLINE = "rays_per_s_per_chip_1024sq_256cube"
# the kernels the bench's paths launch, by the name chip_smoke.py's kernels
# line gives them; their sources, built together before the first metric
KERNELS = {"composite_march": RK.composite_march_cuda,
           "iso_march": IK.iso_march_cuda,
           "iso_shade": IK.iso_shade_cuda,
           "composite_march_pooled_narrow": RK.composite_march_pooled_narrow_cuda,
           "composite_march_pooled_pair16": RK.composite_march_pooled_pair16_cuda,
           "tf_march": TK.tf_march_cuda,
           "voxel_grad": VK.voxel_grad_cuda}
SOURCES = ("composite_march", "iso_march", "iso_shade", "tf_march", "voxel_grad")


def orbit_camera(az_deg: float, width: int, height: int) -> Camera:
    """The bench's orbit: the default eye (0, 0, -0.75) rotated by
    ``az_deg`` about +y, looking at the volume's center."""
    a = math.radians(az_deg)
    return Camera(width=width, height=height,
                  position=(0.75 * math.sin(a), 0.0, -0.75 * math.cos(a)),
                  front=(-math.sin(a), 0.0, math.cos(a)))


def time_sweep(fn, reps: int = REPS, n_frames: int = N_FRAMES):
    """Seconds per frame of ``fn``, a sweep returning a scalar tensor: one
    warm call, then the min over ``reps`` calls, each forced by a host read
    of its scalar, by the host clock, divided by ``n_frames``, which MUST be
    the number of frames one call renders.  Returns (seconds per frame, the
    last call's scalar)."""
    float(fn())
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        value = float(fn())
        best = min(best, time.perf_counter() - t0)
    return best / n_frames, value


def sleep_cycles_per_ms() -> float:
    """The clock cycles ``torch.cuda._sleep`` spins per ms on this card."""
    if not hasattr(sleep_cycles_per_ms, "rate"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1_000_000)
        end.record()
        end.synchronize()
        sleep_cycles_per_ms.rate = 1_000_000 / start.elapsed_time(end)
    return sleep_cycles_per_ms.rate


def time_ms(fn, reps: int = REPS) -> float:
    """Min over ``reps`` of one call of ``fn`` after a warm call, in ms (CUDA
    events around work on the current stream).  Before each start event the
    card spins for twice the warm call's host time (at most 50 ms), so the
    host has queued ``fn``'s launches before the card reaches them: a kernel
    shorter than its wrapper's host cost is timed on the card, not by the
    host's pace."""
    t0 = time.perf_counter()
    fn()
    spin_ms = min(2e3 * (time.perf_counter() - t0), 50.0)
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * sleep_cycles_per_ms()))
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(metric: str, value: float, unit: str, vs_baseline: float) -> None:
    """One metric line, with ``bench.py``'s four keys."""
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "vs_baseline": vs_baseline}), flush=True)


def emit_rate(metric: str, seconds_per_frame: float, rays: int) -> None:
    rays_per_s = rays / seconds_per_frame
    emit(metric, rays_per_s, "rays/s", rays_per_s / NOMINAL_BASELINE_RAYS_PER_S)


def note(obj: dict) -> None:
    print("# " + json.dumps(obj), flush=True)


def timed(fn, device: torch.device, n_frames: int) -> tuple[float, dict]:
    """:func:`time_sweep` of ``fn`` with the launches of :data:`KERNELS` over
    its calls, then the card's time per frame by :func:`time_ms` (not on the
    CPU).  Returns (seconds per frame, the facts for the ``#`` line)."""
    for f in KERNELS.values():
        f.launches = 0
    seconds, value = time_sweep(fn, REPS, n_frames)
    launches = {name: f.launches for name, f in KERNELS.items()}
    card = time_ms(fn) / n_frames if device.type == "cuda" else "not measured"
    return seconds, {"host_ms_per_frame": 1e3 * seconds, "event_ms_per_frame": card,
                     "sweep_sum": value, "renders": (REPS + 1) * n_frames,
                     "launches": launches}


def sweep_isosurface(vol: torch.Tensor, plans, iso: float, bounds) -> torch.Tensor:
    """Σ rgb over the orbit's isosurface frames, each plan with its bound."""
    acc = torch.zeros((), device=vol.device)
    for plan, bound in zip(plans, bounds):
        rgb, _ = plan.render(vol, iso, bound=bound)
        acc = acc + rgb.sum()
    return acc


def sweep_pooled(pool: torch.Tensor, slab_map: torch.Tensor, plans) -> torch.Tensor:
    """Σ rgb over the orbit's frames from a slab pool, unbound: B6 for a
    narrow pool, B7 for a pair16 pool."""
    acc = torch.zeros((), device=pool.device)
    for plan in plans:
        rgb, _ = plan.render_pooled(pool, slab_map)
        acc = acc + rgb.sum()
    return acc


def sweep_compositing(vol: torch.Tensor, plans) -> torch.Tensor:
    """Σ rgb over the orbit's compositing frames, one B1 launch each."""
    acc = torch.zeros((), device=vol.device)
    for plan in plans:
        rgb, _ = plan.render(vol)
        acc = acc + rgb.sum()
    return acc


def forward_frame(plan, vol: torch.Tensor) -> torch.Tensor:
    """Σ rgb of one compositing frame, the voxel metric's unit."""
    rgb, _ = plan.render(vol)
    return rgb.sum()


def voxel_grad_step(render, params: TFParams, vol: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
    """One voxel-gradient step through ``render = make_render_tf_voxel(plan)``:
    the MSE against ``target``, its gradients over the TF parameters and the
    volume, returned as ``d alpha_scale + Σ dvolume``.  The leaves are fresh
    on every call, so no graph or gradient carries over."""
    leaves = TFParams(*(t.clone().requires_grad_(True) for t in params))
    v = vol.detach().requires_grad_(True)
    rgb, _ = render(leaves, v)
    loss = torch.mean((rgb - target) ** 2)
    *g_params, g_vol = torch.autograd.grad(loss, [*leaves, v])
    return g_params[0] + g_vol.sum()


def bench_isosurface(vol: torch.Tensor, plans) -> None:
    """The isosurface at the volume's median (``bench.py:75-124``): a
    surface that exists in the turbulence, where the reference's 40/255
    leaves almost every ray marching to its end."""
    iso = IK.volume_median(vol)
    bounds = [p.bind(vol, iso) for p in plans]
    seconds, facts = timed(lambda: sweep_isosurface(vol, plans, iso, bounds), vol.device,
                           len(plans))
    note({"metric": ISO_METRIC, "iso": iso, **facts})
    emit_rate(ISO_METRIC, seconds, math.prod(plans[0].shape))


def bench_pooled(vol: torch.Tensor, plans) -> None:
    """The compressed-domain march from the volume's sparse slab pools
    (``bench.py:180-222``): the narrow pool (B6), then pair16 (B7)."""
    pools = {"narrow": RK.build_slab_pool_narrow(vol), "pair16": RK.build_slab_pool(vol)}
    for fmt, metric in POOLED_METRICS.items():
        pool, slab_map = pools[fmt]
        seconds, facts = timed(lambda: sweep_pooled(pool, slab_map, plans), vol.device,
                               len(plans))
        note({"metric": metric, "pool_slots": int(pool.shape[0]), **facts})
        emit_rate(metric, seconds, math.prod(plans[0].shape))


def bench_voxel_grad(vol: torch.Tensor, plan) -> None:
    """One voxel-gradient step over one forward frame (``bench.py:127-177``),
    each timed on its own."""
    params = TFParams.reference(vol.device)
    target = torch.full(plan.shape + (3,), 0.5, device=vol.device)
    render = VK.make_render_tf_voxel(plan)
    frame_s, frame = timed(lambda: forward_frame(plan, vol), vol.device, 1)
    step_s, step = timed(lambda: voxel_grad_step(render, params, vol, target), vol.device, 1)
    ratio = step_s / frame_s
    note({"metric": VOXEL_METRIC, "forward_frame": frame, "step": step})
    emit(VOXEL_METRIC, ratio, "forward-frames/step", 3.0 / max(ratio, 1e-9))


def bench_compositing(vol: torch.Tensor, plans) -> None:
    """The headline (``bench.py:251-275``)."""
    seconds, facts = timed(lambda: sweep_compositing(vol, plans), vol.device, len(plans))
    note({"metric": HEADLINE, **facts})
    emit_rate(HEADLINE, seconds, math.prod(plans[0].shape))


def run(device: torch.device | str = "cuda", shape=VOLUME, width: int = W, height: int = H,
        n_frames: int = N_FRAMES) -> int:
    """Print the five metrics for a ``shape`` (Z, Y, X) turbulence volume
    and an orbit of ``n_frames`` ``width`` x ``height`` frames on
    ``device``.  Returns 1 if a secondary metric failed, else 0; a failing
    headline raises."""
    device = torch.device(device)
    if device.type == "cuda":
        _build.load_many(SOURCES)
        gpu = nvidia_smi()
    else:
        gpu = "none (a CPU run: plain versions, no card time)"
    note({"gpu": gpu, "device": str(device), "torch": torch.__version__,
          "volume": list(shape), "image": [width, height], "frames": n_frames, "reps": REPS})
    vol = as_normalized_volume(turbulence_volume(tuple(shape), seed=0), device=device)
    Z, Y, X = vol.shape
    bundles = [generate_rays(orbit_camera(2.0 * i, width, height), device=device)
               for i in range(n_frames)]
    plans = [plan_compositing(r.entry_uv, r.direction, r.hit, (X, Y, Z)) for r in bundles]
    plans_iso = [IK.IsosurfacePlan(r.entry_uv, r.direction, r.hit, (X, Y, Z)) for r in bundles]

    failed = 0
    for name, bench in (("isosurface", lambda: bench_isosurface(vol, plans_iso)),
                        ("pooled", lambda: bench_pooled(vol, plans)),
                        ("voxel-grad", lambda: bench_voxel_grad(vol, plans[0]))):
        try:
            bench()
        except Exception as exc:  # a secondary metric must not sink the headline
            traceback.print_exc()
            print(f"# {name} bench failed: {exc!r}", flush=True)
            failed = 1
    bench_compositing(vol, plans)
    return failed


def main() -> int:
    if not torch.cuda.is_available():
        print("volumerenderer_tpu_torch.bench: torch.cuda.is_available() is False; the bench "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    return run("cuda")


if __name__ == "__main__":
    sys.exit(main())
