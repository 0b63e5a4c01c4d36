"""Tiny cells for the CPU tests: every cell of ``BENCHMARK.json`` at the
size its session class gives (``shrink``): by default a few hundred rays
over a volume of a few tens of voxels a side."""
import json
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH_DIR = ROOT / "benchmark"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def session_class(cell, bench=BENCH, bench_dir=BENCH_DIR):
    from vrbench import harness, traffic

    _, _, mix = harness.load_cell(bench, cell, bench_dir)
    return traffic.session_class(mix["render"], bench_dir)


def shrink(cfg, mix, bench_dir=BENCH_DIR):
    from vrbench import traffic

    traffic.session_class(mix["render"], bench_dir).shrink(cfg, mix)


def run(cell, seed=2147483900, trace=False, program=None, edit=None, stand_ins=(), bench=BENCH,
        bench_dir=BENCH_DIR):
    from vrbench import harness

    def both(cfg, mix):
        shrink(cfg, mix, bench_dir)
        if edit is not None:
            edit(cfg, mix)

    return harness.run_cell(bench, cell, seed, 0.3, trace, torch.device("cpu"),
                            time.perf_counter(), program=program, quiet=True, edit=both,
                            stand_ins=stand_ins, bench_dir=bench_dir)
