"""The readings the limits of the check that decides ``correct`` are set
from, on the card at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seconds 2 --seeds <n> [<n> ...] \
        [--stand-ins bfloat16 half_batch]

For each seed one run of the cell (a short window), then its numbers
compared: the program's (the lower readings), and each stand-in's put in
the program's place: ``bfloat16``, the plain reference computed in the
precision below the configuration's float32 (the control), and, for a fit,
``half_batch``, the reference over half of the views (a planted fault).
All seeds run in one process, so the kernels build once.  One JSON line a
seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--stand-ins", nargs="*", default=["bfloat16"])
    args = ap.parse_args(argv)

    import torch

    from vrbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        detail = {}
        _, checks, stand = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                                            device, t0, quiet=True, stand_ins=args.stand_ins,
                                            detail=detail)
        line = {"workload": args.workload, "seed": seed,
                "program": {k: c["value"] for k, c in checks.items()}, **stand,
                "seconds": time.perf_counter() - t0, "detail": detail}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
