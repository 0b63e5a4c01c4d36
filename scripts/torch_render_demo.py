"""Render one image of every render mode of the PyTorch port into PNG files.

    python3 scripts/torch_render_demo.py [--out out] [--device cuda]

Counterpart of ``scripts/render_demo.py`` (the JAX package's), with its
inputs (``turbulence_volume(dims, seed=7)``, the default camera) and its five
files, the reference's visual-inspection surface:

* ``compositing.png``: the dense compositing render; on the card one launch
  of B1 through a ``plan_compositing`` plan;
* ``isosurface.png``: the isosurface at 90/255, through
  ``best_isosurface_renderer()`` (B2 and B3 on the card);
* ``compressed_full.png`` and ``compressed_coarse.png``: the kd-tree at
  tolerance 2, 2 epochs, rendered at its full cut and at ``orig_depth - 6``;
  on the card from the tree's slab pool through
  ``CompressedRenderer.make_plan(pooled=True)`` (B7);
* ``error_field.png``: ``query_error`` of the tree's leaf cut against the
  volume, rendered as the compositing image is.

With ``device="cpu"`` each image comes from the plain version of the same
render.  An image is ``(clip(rgb, 0, 1) * 255).astype(uint8)``, written by
``write_png`` (8-bit RGB, filter 0, zlib; no imaging library needed) and read
back by ``read_png``.
"""
from __future__ import annotations

import argparse
import os
import struct
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.codecs import kdtree as K
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.models import (CompressedRenderer, best_isosurface_renderer,
                                             plan_compositing)
from volumerenderer_tpu_torch.ops.isosurface import render_isosurface
from volumerenderer_tpu_torch.ops.raycast import render_compositing

IMAGES = ("compositing", "isosurface", "compressed_full", "compressed_coarse", "error_field")
ISO_VALUE = 90 / 255.0
TREE_TOLERANCE, TREE_EPOCHS, COARSE_LEVELS = 2, 2, 6
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(rgb) -> np.ndarray:
    """An (H, W, 3) image in [0, 1] -> uint8, as the JAX script converts it."""
    rgb = rgb.cpu().numpy() if isinstance(rgb, torch.Tensor) else np.asarray(rgb)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG: one IHDR, one
    IDAT of the rows, each led by filter byte 0, and IEND."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes an (H, W, 3) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    H, W, _ = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, 3 * W)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG as ``write_png`` writes it (8-bit RGB, not interlaced,
    every row filter 0; any number of IDAT chunks) into (H, W, 3) uint8,
    checking each chunk's CRC32; anything else raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC32 in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: only 8-bit RGB without interlace is read, got {header}")
    W, H = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + 3 * W)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only filter 0 rows are read")
    return rows[:, 1:].reshape(H, W, 3).copy()


def demo_inputs(size: int, dims, device):
    """(vol_u8 numpy, the normalized volume on ``device``, the default
    camera's rays at ``size``^2)."""
    vol_u8 = turbulence_volume(tuple(dims), seed=7)
    vol = as_normalized_volume(vol_u8, device=device)
    rays = generate_rays(Camera(width=size, height=size), device=device)
    return vol_u8, vol, rays


def build_tree(vol_u8: np.ndarray):
    """The demo's kd-tree and its build's seconds."""
    t0 = time.perf_counter()
    tree = K.build(vol_u8, tolerance=TREE_TOLERANCE, max_epochs=TREE_EPOCHS)
    return tree, time.perf_counter() - t0


def renders(vol_u8: np.ndarray, vol: torch.Tensor, rays, tree, plain: bool = False) -> dict:
    """Name -> zero-argument callable giving that image's rgb (H, W, 3): the
    kernels' entry points (a ``plan_compositing`` plan, B1; the isosurface
    renderer, B2 and B3; ``make_plan(pooled=True)``, B7), or with ``plain``
    the plain renders.  Tensors on the CPU run each wrapper's plain version."""
    dev = vol.device
    err = as_normalized_volume(K.query_error(K.level_cut(tree), vol_u8), device=dev)
    coarse = tree.orig_depth - COARSE_LEVELS
    r = CompressedRenderer(tree, dev)
    if plain:
        def composite(v):
            return lambda: render_compositing(v, rays.entry_uv, rays.direction, rays.hit)[0]

        return {"compositing": composite(vol),
                "isosurface": lambda: render_isosurface(vol, rays.entry_uv, rays.direction,
                                                        rays.hit, ISO_VALUE)[0],
                "compressed_full": lambda: r.render(rays)[0],
                "compressed_coarse": lambda: r.render(rays, cut_depth=coarse)[0],
                "error_field": composite(err)}
    Z, Y, X = vol.shape
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    iso = best_isosurface_renderer()
    full = r.make_plan(rays, pooled=True)
    coarse_plan = r.make_plan(rays, cut_depth=coarse, pooled=True)
    return {"compositing": lambda: plan.render(vol)[0],
            "isosurface": lambda: iso(vol, rays.entry_uv, rays.direction, rays.hit,
                                      ISO_VALUE)[0],
            "compressed_full": lambda: full()[0],
            "compressed_coarse": lambda: coarse_plan()[0],
            "error_field": lambda: plan.render(err)[0]}


def main(out_dir: str = "out", size: int = 512, dims=(128, 128, 128),
         device="cuda") -> tuple[dict, float]:
    """Write the five images under ``out_dir``, through the kernels on a CUDA
    ``device`` and the plain renders on the CPU; returns (name -> rgb (H, W,
    3) tensor, the tree build's seconds)."""
    os.makedirs(out_dir, exist_ok=True)
    vol_u8, vol, rays = demo_inputs(size, dims, device)
    tree, build_s = build_tree(vol_u8)
    images = {}
    for name, render in renders(vol_u8, vol, rays, tree, plain=vol.device.type == "cpu").items():
        images[name] = render()
        path = os.path.join(out_dir, f"{name}.png")
        write_png(path, to_uint8(images[name]))
        print("wrote", path)
    return images, build_s


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.out, device=a.device)
