"""Which ``torch.profiler`` runs keep their kernels' records in the
exported Chrome trace, on one CUDA card.

A 1024^2 pooled isosurface frame (two kernels: the march and the shade) of
a 64^3 kd-tree is profiled in small runs, each after 30 s of frames
rendered while nothing is profiled: a plain run, one with a profiler
schedule's warm-up step, one opened right after a throwaway run, and one
whose frames follow 300 small kernels.  Each prints one JSON line with the
kernels its trace holds by name.  With ``DISABLE_CUPTI_LAZY_REINIT`` set in
the environment only the first two runs are made (kineto's own switches,
e.g. ``DISABLE_CUPTI_LAZY_REINIT=1 TEARDOWN_CUPTI=0``).

Usage (on a machine with a CUDA card, from the repository's root):
    python3 scripts/torch_profiler_probe.py
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.profiler import ProfilerActivity, profile, schedule

from volumerenderer_tpu_torch import Camera, generate_rays
from volumerenderer_tpu_torch.codecs import kdtree as KT
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.models import CompressedRenderer

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profiler_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    tree = KT.build(turbulence_volume((64, 64, 64), seed=1), tolerance=4, max_epochs=1)
    rays = generate_rays(Camera(width=1024, height=1024), device=dev)
    frame = CompressedRenderer(tree, dev).make_plan(rays, mode="isosurface", pooled=True)
    frame()
    torch.cuda.synchronize()
    work = tempfile.mkdtemp()

    def report(prof, tag):
        path = os.path.join(work, tag + ".json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = {}
        for e in events:
            if e.get("cat") == "kernel":
                names[e["name"][:40]] = names.get(e["name"][:40], 0) + 1
        print(json.dumps({"tag": tag, "env": os.environ.get("DISABLE_CUPTI_LAZY_REINIT"),
                          "kernels": names}), flush=True)

    def frames_unprofiled(seconds=30.0):
        t0 = time.time()
        while time.time() - t0 < seconds:
            frame()
            torch.cuda.synchronize()
            time.sleep(0.05)

    with profile(activities=ACTIVITIES) as prof:
        frame()
        torch.cuda.synchronize()
    report(prof, "first")
    frames_unprofiled()
    with profile(activities=ACTIVITIES) as prof:
        for _ in range(2):
            frame()
        torch.cuda.synchronize()
    report(prof, "plain_small")
    if os.environ.get("DISABLE_CUPTI_LAZY_REINIT"):
        return 0
    frames_unprofiled()
    with profile(activities=ACTIVITIES, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        frame()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(2):
            frame()
        torch.cuda.synchronize()
        prof.step()
    report(prof, "warmup_step")
    frames_unprofiled()
    with profile(activities=ACTIVITIES):
        torch.zeros(1, device=dev).add_(1.0)
        torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as prof:
        for _ in range(2):
            frame()
        torch.cuda.synchronize()
    report(prof, "after_throwaway_run")
    frames_unprofiled()
    x = torch.zeros(1, device=dev)
    with profile(activities=ACTIVITIES) as prof:
        for _ in range(300):
            x.add_(1.0)
        for _ in range(2):
            frame()
        torch.cuda.synchronize()
    report(prof, "300_small_kernels_first")
    return 0


if __name__ == "__main__":
    sys.exit(main())
