"""Bricked volume I/O: the reference ``VolumeReader``'s brick loading
(``VolumeReader.h``) and its Richtmyer-Meshkov dataset layout
(``main.cpp:580-619``), in host numpy.

Counterpart of ``volumerenderer_tpu/io/bricks.py`` (``BrickGrid`` :33,
``rm_brick_path`` :57, ``load_brick_file`` :62, ``file_brick_source`` :77,
``synthetic_brick_source`` :88, ``assemble_bricks`` :113, ``load_bricks``
:132), with the same brick placement, so both packages assemble equal arrays:
brick ``b`` sits at ``grid.brick_coords(b)`` (``fillVolumeBrickMap``,
``main.cpp:599-619``: i fastest, then j, then k) inside the (I, J, K) of the
load, one block assignment per brick into a (Z, Y, X) array (the vectorized
form of ``LoadBricksToTexture``'s row copies, ``VolumeReader.h:151-223``).

One difference: where a brick's (i, j, k) falls outside the load's (I, J, K)
(a grid of more bricks per axis than the load takes, e.g. the default RM grid
loaded as 2 x 2 x 2), ``assemble_bricks`` raises a ``ValueError`` naming the
brick and both grids before it reads any brick.  The JAX package places such
a brick into an empty slice and fails in numpy's broadcast instead
(``volumerenderer_tpu/io/bricks.py:124-128``).  Either way the load is an
error.

``synthetic_brick_source`` draws from the port's own ``io/synthetic.py``,
whose volumes are byte-identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np

__all__ = ["BrickGrid", "rm_brick_path", "load_brick_file", "assemble_bricks",
           "load_bricks", "synthetic_brick_source", "file_brick_source",
           "RM_BRICK_DIMS", "RM_VOLUME_GRID"]

RM_BRICK_DIMS = (256, 256, 128)   # (X, Y, Z) per brick, main.cpp:78
RM_VOLUME_GRID = (8, 8, 15)       # (I, J, K) bricks,     main.cpp:79


@dataclasses.dataclass(frozen=True)
class BrickGrid:
    """Brick decomposition of a volume: ``brick_dims`` = (X, Y, Z) cells per
    brick, ``grid`` = (I, J, K) bricks per axis."""

    brick_dims: tuple[int, int, int] = RM_BRICK_DIMS
    grid: tuple[int, int, int] = RM_VOLUME_GRID

    def brick_coords(self, b: int) -> tuple[int, int, int]:
        """brick number -> (i, j, k); i fastest (``fillVolumeBrickMap``)."""
        I, J, K = self.grid
        return (b % I, (b // I) % J, b // (I * J))

    def num_bricks(self) -> int:
        I, J, K = self.grid
        return I * J * K

    def volume_dims(self, I=None, J=None, K=None) -> tuple[int, int, int]:
        """(X, Y, Z) of the assembled volume for a sub-grid (defaults: full)."""
        bi, bj, bk = self.grid
        I, J, K = I or bi, J or bj, K or bk
        bx, by, bz = self.brick_dims
        return (I * bx, J * by, K * bz)


def rm_brick_path(top_dir: str, brick: int, timestep: int) -> str:
    """``bob<ttt>/d_<tttt>_<bbbb>`` (``findBrickBinaryFile``, main.cpp:580-597)."""
    return os.path.join(top_dir, f"bob{timestep:03d}", f"d_{timestep:04d}_{brick:04d}")


def load_brick_file(path: str, brick_dims: tuple[int, int, int],
                    dtype=np.uint8) -> np.ndarray:
    """Read one raw brick file into a (Z, Y, X) array, with the reference's
    strict size check (``VolumeReader.h:253-261``)."""
    X, Y, Z = brick_dims
    expected = X * Y * Z * np.dtype(dtype).itemsize
    actual = os.path.getsize(path)
    if actual != expected:
        raise ValueError(
            f"File size does not match expected dataset size: {path} "
            f"has {actual} bytes, expected {expected}")
    data = np.fromfile(path, dtype=dtype)
    return data.reshape(Z, Y, X)  # file is x-fastest


def file_brick_source(top_dir: str, grid: BrickGrid,
                      dtype=np.uint8) -> Callable[[int, int], np.ndarray]:
    """Brick source reading the RM dataset layout from disk."""

    def source(brick: int, timestep: int) -> np.ndarray:
        return load_brick_file(rm_brick_path(top_dir, brick, timestep),
                               grid.brick_dims, dtype)

    return source


def synthetic_brick_source(grid: BrickGrid, kind: str = "turbulence"
                           ) -> Callable[[int, int], np.ndarray]:
    """Deterministic synthetic bricks keyed by (brick, timestep): a window of
    one global sphere (``kind="sphere"``), or a turbulence brick seeded by
    (timestep, brick)."""
    from .synthetic import sphere_volume, turbulence_volume

    bx, by, bz = grid.brick_dims

    def source(brick: int, timestep: int) -> np.ndarray:
        i, j, k = grid.brick_coords(brick)
        if kind == "sphere":
            I, J, K = grid.grid
            # window of a global sphere centered in the full grid
            center = ((I / 2 - i) / 1, (J / 2 - j), (K / 2 - k))
            return sphere_volume((bz, by, bx),
                                 center=(0.5 + center[2], 0.5 + center[1], 0.5 + center[0]),
                                 radius=1.0, soft=0.5)
        rng_seed = (timestep * 131071 + brick) & 0x7FFFFFFF
        return turbulence_volume((bz, by, bx), seed=rng_seed)

    return source


def assemble_bricks(source: Callable[[int, int], np.ndarray], grid: BrickGrid,
                    num_bricks: int, I: int, J: int, K: int, timestep: int,
                    out: np.ndarray | None = None) -> np.ndarray:
    """Assemble ``num_bricks`` bricks into a dense (Z, Y, X) volume of I x J
    x K bricks.  ``out`` may be a preallocated array or memmap for
    out-of-core assembly.  Raises ``ValueError`` where a brick's (i, j, k)
    lies outside (I, J, K)."""
    bx, by, bz = grid.brick_dims
    X, Y, Z = I * bx, J * by, K * bz
    for b in range(num_bricks):
        i, j, k = grid.brick_coords(b)
        if i >= I or j >= J or k >= K:
            raise ValueError(
                f"brick {b} sits at (i, j, k) = {(i, j, k)} of the brick grid "
                f"{tuple(grid.grid)}, outside the load's (I, J, K) = {(I, J, K)}")
    if out is None:
        out = np.zeros((Z, Y, X), dtype=np.uint8)
    if out.shape != (Z, Y, X):
        raise ValueError(f"out has shape {out.shape}, the load needs {(Z, Y, X)}")
    for b in range(num_bricks):
        i, j, k = grid.brick_coords(b)
        brick = source(b, timestep)
        out[k * bz:(k + 1) * bz, j * by:(j + 1) * by, i * bx:(i + 1) * bx] = brick
    return out


def load_bricks(source, grid: BrickGrid, num_bricks: int, I: int, J: int,
                K: int, timestep: int) -> np.ndarray:
    """Reference call shape: ``volume.LoadBricksToTexture(384, 8, 8, 6, 273,
    ...)`` (``main.cpp:242``)."""
    return assemble_bricks(source, grid, num_bricks, I, J, K, timestep)
