"""One-command smoke test of the Richtmyer-Meshkov (RM) dataset on the
PyTorch port.

    python3 scripts/torch_rm_smoke.py --rm-dir DIR [--timestep 273]
        [--bricks 8] [--grid 8,1,1] [--no-codec] [--render]
        [--device cuda] [--out out]

Counterpart of ``scripts/rm_smoke.py`` (the JAX package's), with its flags
and its steps, in the order of the reference's ``main()`` (``main.cpp:242-292``):

1. **Discovery**: ``bob<ttt>/d_<tttt>_<bbbb>`` (``main.cpp:580-597``) for
   each of the first ``--bricks`` bricks.  A missing file prints ``MISSING n
   brick files, e.g. <path>`` and the script returns 1.
2. **Size check and assembly**: every brick is exactly 256x256x128 bytes
   (``VolumeReader.h:253-261``; a file of another size raises
   ``ValueError``), placed by the i-fastest brick map
   (``main.cpp:599-619``) into the (I, J, K) of ``--grid``.  Prints the
   shape, the CRC32 of the C-order bytes (a golden for the real data), min,
   max and mean.  The default grid is the first 8 bricks of a row, 8,1,1
   (2048x256x128); a grid whose bricks do not all lie inside the load, as
   2,2,2 on the RM grid of 8x8x15 bricks, raises the loader's ``ValueError``
   naming the brick and both grids, and a grid of other than ``--bricks``
   bricks raises ``ValueError``.
3. **Codec round trip** (unless ``--no-codec``): ``codecs.kdtree.build`` at
   tolerance 1, 2 epochs (``main.cpp:253-258``), then the leaf cut
   (``level_cut(tree, tree.orig_depth)``); prints its max and mean error and
   the active nodes.
4. ``--render``: one 1024^2 compositing frame of the **assembled** volume
   (as the JAX script renders it, whatever its docstring says) through
   ``plan_compositing``, so the march kernel B1 runs on the card; writes
   ``<out>/rm_frame.npy``.

With ``--device cpu`` every step runs on the CPU and the frame is the plain
march's.  The steps are functions (``discover``, ``assemble``,
``codec_round_trip``, ``render_frame``) that ``main`` calls in turn.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.codecs import kdtree as K
from volumerenderer_tpu_torch.io.bricks import (BrickGrid, file_brick_source, load_bricks,
                                                rm_brick_path)
from volumerenderer_tpu_torch.models import plan_compositing

RM_GRID = BrickGrid()                     # 256x256x128 bricks, 8x8x15 of them
CODEC_TOLERANCE, CODEC_EPOCHS = 1, 2      # main.cpp:253-258
FRAME_SIZE = 1024


def parse_grid(text: str, bricks: int) -> tuple[int, int, int]:
    """``"I,J,K"`` -> (I, J, K); raises ``ValueError`` unless I * J * K is
    ``bricks``."""
    I, J, K = (int(v) for v in text.split(","))
    if I * J * K != bricks:
        raise ValueError(f"--grid {text} holds {I * J * K} bricks, --bricks is {bricks}")
    return I, J, K


def discover(rm_dir: str, bricks: int, timestep: int) -> list[str]:
    """The paths of the first ``bricks`` brick files of ``timestep`` that do
    not exist."""
    return [p for p in (rm_brick_path(rm_dir, b, timestep) for b in range(bricks))
            if not os.path.exists(p)]


def volume_crc32(vol: np.ndarray) -> int:
    """CRC32 of the volume's C-order bytes."""
    return zlib.crc32(np.ascontiguousarray(vol).tobytes())


def assemble(rm_dir: str, bricks: int, ijk: tuple[int, int, int], timestep: int,
             grid: BrickGrid = RM_GRID) -> np.ndarray:
    """The size-checked bricks assembled into a (Z, Y, X) uint8 volume."""
    return load_bricks(file_brick_source(rm_dir, grid), grid, bricks, *ijk, timestep)


def codec_round_trip(vol: np.ndarray) -> dict:
    """``kdtree.build`` at the reference's settings and its leaf cut's errors."""
    t0 = time.perf_counter()
    tree = K.build(vol, tolerance=CODEC_TOLERANCE, max_epochs=CODEC_EPOCHS)
    build_s = time.perf_counter() - t0
    rec = K.level_cut(tree, tree.orig_depth)
    return {"max_err": K.measure_max_error(rec, vol), "mean_err": K.measure_mean_error(rec, vol),
            "active_nodes": int(tree.num_active_nodes), "depth": int(tree.orig_depth),
            "build_s": build_s}


def render_frame(vol: np.ndarray, device, size: int = FRAME_SIZE):
    """One ``size``^2 compositing frame of ``vol`` from the default camera:
    (rgb (size, size, 3), alpha), B1 on a CUDA device, the plain march on the
    CPU."""
    nv = as_normalized_volume(vol, device=device)
    Z, Y, X = nv.shape
    rays = generate_rays(Camera(width=size, height=size), device=device)
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    return plan.render(nv)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rm-dir", required=True, help="dataset root holding bob<ttt>/ directories")
    ap.add_argument("--timestep", type=int, default=273)
    ap.add_argument("--bricks", type=int, default=8, help="number of bricks to load (I*J*K)")
    ap.add_argument("--grid", default="8,1,1",
                    help="I,J,K sub-grid to assemble (x, y, z brick counts)")
    ap.add_argument("--no-codec", action="store_true")
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="out")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    ijk = parse_grid(args.grid, args.bricks)

    missing = discover(args.rm_dir, args.bricks, args.timestep)
    if missing:
        print(f"MISSING {len(missing)} brick files, e.g. {missing[0]}")
        return 1
    print(f"found {args.bricks} brick files for timestep {args.timestep}")

    vol = assemble(args.rm_dir, args.bricks, ijk, args.timestep, RM_GRID)
    print(f"assembled {vol.shape} volume; CRC32 0x{volume_crc32(vol):08x}; "
          f"min {vol.min()} max {vol.max()} mean {vol.mean():.3f}")

    if not args.no_codec:
        c = codec_round_trip(vol)
        print(f"codec leaf cut: max err {c['max_err']}, mean {c['mean_err']:.4f}, "
              f"active nodes {c['active_nodes']}, depth {c['depth']}, "
              f"built in {c['build_s']:.1f} s")

    if args.render:
        rgb, _ = render_frame(vol, args.device, FRAME_SIZE)
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "rm_frame.npy")
        np.save(path, rgb.cpu().numpy())
        print(f"wrote {path}; rendered on {rgb.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
