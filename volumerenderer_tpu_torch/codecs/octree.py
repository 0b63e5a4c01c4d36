"""Octree codec, in host numpy: the reference's unfinished ``Octree``
prototype (``Octree.cpp``/``Octree.h``; no compression or serialization was
ever written there).

Counterpart of ``volumerenderer_tpu/codecs/octree.py`` (``Octree`` :30,
``build`` :42, ``level_cut`` :93), array for array:

* a non-cubic volume first splits in two along its larger axes (cycling
  through the non-minimum dims, ``Octree.cpp:34-53,98-104``) until the
  domain factors into cubes, then splits 8 ways (``:106-111``);
* every node holds the truncated average of its box (``Octree.cpp:79-91``),
  from int64 level sums reduced by reshapes, one (nz, ny, nx) array per
  level;
* ``level_cut`` fills every box of a depth with its average, the decode the
  prototype never had.

Power-of-two dims only, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Octree", "build", "level_cut"]


@dataclasses.dataclass
class Octree:
    dims: tuple[int, int, int]            # (X, Y, Z)
    start_depth: int                      # binary levels before 8-way splits
    depth: int                            # total levels below the root
    split_dims: list[int]                 # binary-phase axis cycle (0=x,1=y,2=z)
    # level d -> scalar grid, shape (nz, ny, nx) of per-box truncated averages
    level_scalars: list[np.ndarray]

    def node_count(self) -> int:
        return sum(s.size for s in self.level_scalars)


def build(volume: np.ndarray) -> Octree:
    """Average pyramid of a (Z, Y, X) uint8 volume."""
    volume = np.asarray(volume, dtype=np.uint8)
    Z, Y, X = volume.shape
    min_dim = min(X, Y, Z)
    if min_dim & (min_dim - 1):
        raise ValueError("octree requires power-of-two dimensions")
    split_dims = [a for a, n in ((0, X), (1, Y), (2, Z)) if n != min_dim]

    # binary levels to reach mini-cubes (Octree.cpp:48-53)
    start_depth = sum(int(np.log2(n // min_dim)) for n in (X, Y, Z))
    oct_depth = int(np.log2(min_dim))  # 8-way levels until 1-cell boxes
    depth = start_depth + oct_depth

    sums = volume.astype(np.int64)
    counts = 1
    grid = (Z, Y, X)  # boxes per axis (z, y, x) at leaf level

    levels: list[np.ndarray] = [None] * (depth + 1)
    levels[depth] = volume.copy()

    # reduce upward: the 8-way levels first (all three axes halve), then the
    # binary ones; each binary split halves one axis of a fixed cycle, so
    # reducing in reverse order gives the boxes of the top-down splits
    for d in range(depth - 1, -1, -1):
        if d >= start_depth:
            nz, ny, nx = grid[0] // 2, grid[1] // 2, grid[2] // 2
            sums = sums.reshape(nz, 2, ny, 2, nx, 2).sum(axis=(1, 3, 5))
            counts *= 8
            grid = (nz, ny, nx)
        else:
            axis = split_dims[d % len(split_dims)] if split_dims else 0
            arr_axis = 2 - axis  # axis 0=x -> array axis 2, 1=y -> 1, 2=z -> 0
            sh = list(grid)
            sh[arr_axis] //= 2
            split = list(grid)
            split[arr_axis:arr_axis + 1] = [sh[arr_axis], 2]
            sums = sums.reshape(split).sum(axis=arr_axis + 1)
            counts *= 2
            grid = tuple(sh)
        levels[d] = (sums // counts).astype(np.uint8)

    return Octree(dims=(X, Y, Z), start_depth=start_depth, depth=depth,
                  split_dims=split_dims, level_scalars=levels)


def level_cut(tree: Octree, cut_depth: int) -> np.ndarray:
    """Fill every depth-``cut_depth`` box with its node average; (Z, Y, X)
    uint8."""
    X, Y, Z = tree.dims
    cut_depth = min(cut_depth, tree.depth)
    s = tree.level_scalars[cut_depth]
    nz, ny, nx = s.shape
    out = np.broadcast_to(
        s[:, None, :, None, :, None],
        (nz, Z // nz, ny, Y // ny, nx, X // nx))
    return np.ascontiguousarray(out).reshape(Z, Y, X)
