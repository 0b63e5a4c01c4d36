"""Tiny cells for the CPU tests: every cell of ``BENCHMARK.json`` at a few
hundred rays over a volume of a few tens of voxels a side."""
import json
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def shrink(cfg, mix):
    cfg["volume"]["shape"] = [24, 28, 32]
    cfg["image"] = [20, 16]
    mix["trace"] = {"warm": 2, "frames": 4}


def run(cell, seed=2147483900, trace=False, program=None, edit=None, stand_ins=()):
    from vrbench import harness

    def both(cfg, mix):
        shrink(cfg, mix)
        if edit is not None:
            edit(cfg, mix)

    return harness.run_cell(BENCH, cell, seed, 0.3, trace, torch.device("cpu"),
                            time.perf_counter(), program=program, quiet=True, edit=both,
                            stand_ins=stand_ins)
