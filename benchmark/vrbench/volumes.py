"""Volumes made on the device from the seed, in a few large calls.

``turbulence`` is the port's synthetic field (multi-octave value noise:
per octave a random cube of ``res = max(2, min(min(shape), 2**(o + 2)))``
values, upsampled trilinearly to the volume by ``linspace(0, res - 1, n)`` on
each axis, summed with halving amplitudes, scaled to [0, 255] and truncated
to bytes), with its random cubes drawn by a ``torch.Generator`` on the
device instead of numpy's, all from one fixed generator.  ``noise`` adds to
every byte a seeded integer drawn uniformly from [-noise, noise] (clamped
to [0, 255]).  So every seed's field has the same structure, and so the
same rendering work, with other bytes: seeds that drew the octaves moved a
fit's pace by a tenth and more.  It is made in z-chunks, so a 3.2 GB volume
needs a few GB beside it.
"""
from __future__ import annotations

from pathlib import Path

import torch

from .named import BENCH_DIR, load_named

CHUNK_BYTES = 1 << 30


def _lerp_axis(a: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    res = a.shape[axis]
    idx = torch.linspace(0, res - 1, n, dtype=torch.float32, device=a.device)
    i0 = torch.floor(idx).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=res - 1)
    f = (idx - i0.to(torch.float32))
    shape = [1] * a.dim()
    shape[axis] = -1
    a0 = a.index_select(axis, i0)
    a1 = a.index_select(axis, i1)
    return a0 + (a1 - a0) * f.reshape(shape)


FIXED_SEED = 0


def turbulence(shape, seed: int, device, octaves: int = 4, noise: int = 0) -> torch.Tensor:
    """A (Z, Y, X) uint8 turbulence volume on ``device``: the octaves the
    same for every seed, each byte then moved by the seed's noise in
    [-noise, noise]."""
    Z, Y, X = (int(n) for n in shape)
    fixed, gen = torch.Generator(device=device), torch.Generator(device=device)
    fixed.manual_seed(FIXED_SEED)
    gen.manual_seed(int(seed) % (1 << 63))
    planes = []  # per octave: (amp, the coarse cube upsampled along x and y)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        res = max(2, min(min(Z, Y, X), 2 ** (o + 2)))
        coarse = torch.rand((res, res, res), generator=fixed, device=device,
                            dtype=torch.float32)
        planes.append((amp, _lerp_axis(_lerp_axis(coarse, X, 2), Y, 1)))
        total += amp
        amp *= 0.5
    z_idx = torch.linspace(0, 1, Z, dtype=torch.float32, device=device)
    rows = max(1, CHUNK_BYTES // (4 * Y * X))

    def chunk(z0, z1):
        acc = torch.zeros((z1 - z0, Y, X), dtype=torch.float32, device=device)
        for a, p in planes:
            res = p.shape[0]
            idx = z_idx[z0:z1] * (res - 1)
            i0 = torch.floor(idx).to(torch.int64)
            i1 = torch.clamp(i0 + 1, max=res - 1)
            f = (idx - i0.to(torch.float32)).reshape(-1, 1, 1)
            p0 = p.index_select(0, i0)
            acc += a * (p0 + (p.index_select(0, i1) - p0) * f)
        return acc / total

    lo, hi = float("inf"), float("-inf")
    for z0 in range(0, Z, rows):
        c = chunk(z0, min(Z, z0 + rows))
        lo, hi = min(lo, float(c.min())), max(hi, float(c.max()))
    out = torch.empty((Z, Y, X), dtype=torch.uint8, device=device)
    for z0 in range(0, Z, rows):
        z1 = min(Z, z0 + rows)
        c = (chunk(z0, z1) - lo) / max(hi - lo, 1e-9)
        b = (c * 255.0).to(torch.uint8)
        if noise:
            d = torch.randint(-noise, noise + 1, b.shape, generator=gen, device=device,
                              dtype=torch.int16)
            b = torch.clamp(b.to(torch.int16) + d, 0, 255).to(torch.uint8)
        out[z0:z1] = b
    return out


def make(spec: dict, seed: int, device, bench_dir: Path = BENCH_DIR) -> torch.Tensor:
    """The (Z, Y, X) volume a configuration's ``volume`` entry names: for
    ``kind`` turbulence (``octaves``, ``noise``) of ``dtype`` uint8 and
    ``shape`` (Z, Y, X) the field above; for any other ``kind``, what
    ``make(spec, seed, device)`` of ``generators/<kind>.py`` under
    ``bench_dir`` makes on the device from the seed."""
    if spec["kind"] != "turbulence":
        return load_named(bench_dir, "generators", spec["kind"]).make(spec, seed, device)
    if spec["dtype"] != "uint8":
        raise ValueError(f"no generator for a {spec['dtype']} volume of kind {spec['kind']!r}")
    return turbulence(spec["shape"], seed, device, spec["octaves"], spec["noise"])
