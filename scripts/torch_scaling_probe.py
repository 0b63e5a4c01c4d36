#!/usr/bin/env python3
"""Scaling probe of the PyTorch/CUDA port on an NVIDIA GPU.

Counterpart of ``scripts/scaling_probe.py``.  It measures:

* ``one_card``: the kernel render's rays/s at 512^2 on the 256^3 turbulence
  (seed 0), one card, ``CompositingPlan.render`` (B1): 8 frames enqueued
  back to back and forced by one scalar read to the host, the min of 3 such
  sweeps after a warm one;
* ``two_ranks_one_card``: two ranks on ``cuda:0`` over gloo
  (``multihost.spawn``), one mesh entry each, the image rows sharded over
  them: ``kernel_sharded.scaling_probe_kernel`` (the per-device throughput
  of the 2-rank mesh against one rank's card alone) and
  ``multihost.measure_scaling_efficiency`` over mesh sizes 1 and 2, and
  whether gloo's ``all_gather`` takes CUDA tensors in this torch.  Two ranks
  that share one card measure the machinery (the row split, the gather
  through the host), not scaling: the card does the same work either way,
  and the gather is added to it.  As the JAX script's ``cpu_mesh`` section,
  it shows that the multi-process path runs and composes.

Prints one JSON line with the card's name and power limit; writes it to
``--out`` too when given.  Needs a CUDA card (exits non-zero without one).

Usage, from the root of a checkout:  python3 scripts/torch_scaling_probe.py [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

W = H = 512
VOLUME = (256, 256, 256)
FRAMES = 8


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def scene(dev):
    from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
    from volumerenderer_tpu_torch.models import plan_compositing

    vol = as_normalized_volume(turbulence_volume(VOLUME, seed=0), device=dev)
    rays = generate_rays(Camera(width=W, height=H), device=dev)
    return vol, plan_compositing(rays.entry_uv, rays.direction, rays.hit, VOLUME[::-1])


def one_card(dev) -> dict:
    vol, plan = scene(dev)

    def sweep() -> float:
        t0 = time.perf_counter()
        s = torch.zeros((), device=dev)
        for _ in range(FRAMES):
            rgb, a = plan.render(vol)
            s = s + rgb.sum() + a.sum()
        s.item()
        return (time.perf_counter() - t0) / FRAMES

    sweep()
    dt = min(sweep() for _ in range(3))
    return {"ms_per_frame": 1e3 * dt, "rays_per_s_512sq_1card": W * H / dt}


def rank_main(dev, out: Path, coordinator: str, num_processes: int, process_id: int) -> None:
    """One rank: joins the group with one entry on ``dev``, then runs the
    probes over the mesh of every rank's entry; rank 0 writes the result."""
    from volumerenderer_tpu_torch.parallel import kernel_sharded as KS
    from volumerenderer_tpu_torch.parallel import multihost as MH
    from volumerenderer_tpu_torch.parallel.sharding import DeviceMesh

    torch.cuda.set_device(dev)
    backend = MH.initialize(coordinator, num_processes, process_id, local_devices=[dev])
    vol, plan = scene(dev)
    meshes = {1: DeviceMesh([dev], ("rays",)), num_processes: MH.global_mesh(("rays",))}

    def render_fn(n):
        rgb, a = KS.render_planned_sharded(meshes[n], plan, vol)
        return float(rgb.sum() + a.sum())

    efficiency = MH.measure_scaling_efficiency(render_fn, sorted(meshes))
    probe = KS.scaling_probe_kernel(meshes[num_processes], plan, vol, frames=FRAMES)
    # both ranks make the same call, so an unsupported device fails on both
    try:
        got = [torch.empty(4, device=dev) for _ in range(num_processes)]
        torch.distributed.all_gather(got, torch.full((4,), float(process_id), device=dev))
        cuda_all_gather = [float(t[0]) for t in got] == [float(r) for r in range(num_processes)]
    except RuntimeError as exc:
        cuda_all_gather = f"refused: {str(exc).splitlines()[0]}"
    if MH.process_index() == 0:
        out.write_text(json.dumps({
            "ranks": num_processes, "backend": backend, "device_per_rank": str(dev),
            "scaling_probe_kernel": probe,
            "measure_scaling_efficiency": {str(n): {"s": s, "efficiency": e}
                                           for n, (s, e) in efficiency.items()},
            "gloo_all_gather_takes_cuda_tensors": cuda_all_gather,
            "note": "two ranks share one card: this measures the row split and the gather "
                    "through the host, not scaling"}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the JSON line to this file")
    ap.add_argument("--rank-of", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_scaling_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.rank_of is not None:
        rank_main(dev, args.rank_of, args.coordinator, args.num_processes, args.process_id)
        return 0
    from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
    from volumerenderer_tpu_torch.parallel import multihost as MH

    RK.load_kernel()  # built once, before the ranks load it
    result = {"date": time.strftime("%Y-%m-%d"), "gpu": nvidia_smi(),
              "torch": torch.__version__, "one_card": one_card(dev)}
    with tempfile.TemporaryDirectory(prefix="scaling_probe_") as work:
        out = Path(work) / "ranks.json"
        MH.spawn([sys.executable, "-u", str(Path(__file__).resolve()), "--rank-of", str(out)],
                 2, timeout=600)
        result["two_ranks_one_card"] = json.loads(out.read_text())
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
