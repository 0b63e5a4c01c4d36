"""Run one cell of the benchmark of volumerenderer_tpu_torch on one NVIDIA GPU.

From the root of a checkout::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name from
``BENCHMARK.json``.  The run pins itself beside the card, makes its inputs
on the card from the seed, warms until the allocator is steady, measures
for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or traces a
short window (``--trace 1``: its per-layer metrics), checks the window's
outputs against the plain reference in ``benchmark/vrbench/reference.py``,
and prints ``#`` lines (the host, the card's state before and after, the
window's spread), then one JSON result as its last line.  Each number
compared is printed with its limit as the last lines on standard error.

Exits 2 without a result when no CUDA device is there (it never falls back
to the CPU), 3 when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    from vrbench import harness

    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False; the benchmark runs on an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} are there", file=sys.stderr)
        return 2
    import volumerenderer_tpu_torch as port

    where = Path(port.__file__).resolve().parent.parent
    if where != ROOT:
        print(f"benchmark: volumerenderer_tpu_torch imported from {where}, not from the "
              f"checkout {ROOT}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        result, checks, _ = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                             bool(args.trace), device, T_START)
    except harness.ForbiddenModules as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
