"""The 8^3 block grid of a volume or a slab pool and the bound that carries
it (:class:`BlockBound`), shared by the exact skips of the isosurface
marches (``ops/isosurface.py::classify_blocks``) and of the compositing
marches (``ops/raycast.py::empty_blocks``).

Per 8^3 block of trilinear tap anchors a grid cell holds the least and the
largest byte the taps of those anchors can read: over the texels [8b, 8b + 8]
of each axis (clamped to the edge, or wrapped for "repeat").  A march looks
up the block of each sample's lower tap anchor (:func:`anchor_cells`, the
sampler's own texel math) and skips the sample where the cell decides it:
the isosurface where the block lies wholly on one side of the isovalue, the
compositing where its largest byte is 0 (a zero sample composites as a
no-op).  A bound records the data it was made from (:func:`data_source`), so
a render with other data raises (:func:`check_bound`).  Every grid build
is one ``vr.grid`` span (``utils/timer.py::span``).
"""
from __future__ import annotations

import dataclasses
import weakref

import torch

from ..utils.timer import span
from .sampling import WRAP_MODES, texel_coords

__all__ = ["ISO_BLOCK", "BlockBound", "data_source", "check_bound", "anchor_cells",
           "check_grid", "iso_block_grid", "iso_grid_from_pool", "iso_grid_from_mip8"]

ISO_BLOCK = 8           # voxels per side of a bound grid's block


@dataclasses.dataclass(frozen=True, eq=False)
class BlockBound:
    """The exact skip of one plan's marches (``CompositingPlan.bind``,
    ``IsosurfacePlan.bind``): the (X, Y, Z) dims and wrap mode of a volume,
    its block grid and the data it was made from, kept together so that a
    march can refuse a grid made for another volume shape, wrap or volume
    (:func:`check_bound`).

    ``grid`` is the (ceil(Z/8), ceil(Y/8), ceil(X/8), 2) uint8 grid (least,
    largest byte per block of tap anchors; a grid from a max-only mip has
    least 0), shared by every bind of the same unchanged data
    (``blockgrid_kernel.bind_grid``): treat it as read-only.  ``source`` (:func:`data_source`) names the tensors the grid
    describes: the volume, or a slab pool and its map; empty for a bound
    built by hand, which only the low-level marches take.  ``has_empty``:
    the grid holds a block to skip (``CompositingPlan.render`` marches
    without a grid that skips nothing); an isosurface bind leaves it True.
    ``iso``: the isovalue of an isosurface bind, None for a compositing
    one; a march refuses a bound made for another isovalue, so the two
    plans' bounds cannot be crossed."""

    dims: tuple
    wrap: str
    grid: torch.Tensor
    source: tuple = ()
    has_empty: bool = True
    iso: float | None = None


def data_source(*tensors) -> tuple:
    """Who the tensors are: a weak reference to each and its version counter
    (which every in-place change bumps), for :func:`check_bound`.  An
    inference-mode tensor has no version counter, so a bound could not see
    it written in place: it raises."""
    for t in tensors:
        if t.is_inference():
            raise ValueError("an inference-mode tensor has no version counter, so a bound "
                             "cannot tell when it is written in place: bind a normal tensor")
    return tuple((weakref.ref(t), t._version) for t in tensors)


def check_bound(bound, dims, wrap: str, iso=None, device=None, data=None):
    """The block grid of ``bound`` after checking that it is a
    :class:`BlockBound` made for this march: the isovalue ``iso`` (None for
    the compositing marches), the volume's (X, Y, Z) ``dims`` (``None``
    skips that check and the grid's), ``wrap``, and, given ``data``, from
    those very tensors, unchanged since (no in-place write); given
    ``device``, the grid lies there.  None for no bound; any mismatch
    raises."""
    if bound is None:
        return None
    if not isinstance(bound, BlockBound):
        raise TypeError(f"bound must be a BlockBound (a plan's bind), got "
                        f"{type(bound).__name__}")
    want = None if iso is None else float(iso)
    if want != bound.iso:
        raise ValueError(f"the bound was made for iso {bound.iso!r}, not {want!r}")
    if dims is not None and tuple(int(d) for d in dims) != bound.dims:
        raise ValueError(f"the bound was made for a volume of (X, Y, Z) = {bound.dims}, "
                         f"not {tuple(dims)}")
    if wrap != bound.wrap:
        raise ValueError(f"the bound was made for wrap={bound.wrap!r}, not {wrap!r}")
    if data is not None:
        same = len(data) == len(bound.source) and all(
            ref() is t and v == t._version for (ref, v), t in zip(bound.source, data))
        if not same:
            raise ValueError("the bound was made from other data than this render's (another "
                             "volume or pool, or one changed since): bind it from this one")
    if dims is not None:
        check_grid(bound.grid, dims, device)
    return bound.grid


def _block_counts(dims):
    return tuple(-(-int(n) // ISO_BLOCK) for n in dims)


def check_grid(grid, dims, device=None) -> None:
    """Raise ValueError unless ``grid`` is the contiguous (ceil(Z/8),
    ceil(Y/8), ceil(X/8), 2) uint8 grid of a volume of ``dims`` (X, Y, Z)
    and, given ``device``, lies there."""
    want = _block_counts(dims)[::-1] + (2,)
    if not isinstance(grid, torch.Tensor) or grid.dtype != torch.uint8 \
            or tuple(grid.shape) != want or not grid.is_contiguous():
        raise ValueError(f"the bound's grid must be a contiguous {want} uint8 tensor")
    if device is not None and grid.device != device:
        raise ValueError(f"the bound's grid is on {grid.device} but the march runs on {device}")


def anchor_cells(grid: torch.Tensor, dims, wrap: str, uvw: torch.Tensor) -> torch.Tensor:
    """The grid cells (..., 2) uint8 of the samples at ``uvw`` (..., 3): the
    block of each sample's lower tap anchor, by the sampler's own texel math,
    the anchor clamped onto the volume (or wrapped for "repeat")."""
    if wrap == "repeat":
        uvw = uvw - torch.floor(uvw)
    i0, _ = texel_coords(uvw, dims)
    n = torch.tensor(dims, dtype=torch.int64, device=uvw.device)
    i = torch.remainder(i0, n) if wrap == "repeat" else torch.clamp(i0, min=0).minimum(n - 1)
    b = i // ISO_BLOCK
    return grid[b[..., 2], b[..., 1], b[..., 0]]


def _footprint_reduce(r: torch.Tensor, axis: int, reduce, pair, wrap: str) -> torch.Tensor:
    """``reduce`` over the texels [8b, 8b + 8] of each block b of ``axis``
    (the last one clamped to the edge, or wrapped)."""
    n = r.shape[axis]
    nb = -(-n // ISO_BLOCK)
    j = torch.arange(ISO_BLOCK * nb + 1, device=r.device)
    ext = r.index_select(axis, j.clamp(max=n - 1) if wrap == "clamp" else j % n)
    body = ext.narrow(axis, 0, ISO_BLOCK * nb)
    blocks = reduce(body.reshape(body.shape[:axis] + (nb, ISO_BLOCK) + body.shape[axis + 1:]),
                    dim=axis + 1)
    return pair(blocks, ext.index_select(axis, j[ISO_BLOCK::ISO_BLOCK]))


def iso_block_grid(volume: torch.Tensor, wrap: str = "clamp") -> torch.Tensor:
    """The block grid from a (Z, Y, X) uint8 volume, or a float volume in
    [0, 1] quantized as the marches sample it (``round(clamp(v, 0, 1) *
    255)``): plain reductions on each axis in turn, over the texels [8b, 8b +
    8] of block b.  The plain version of
    ``ops/cuda/blockgrid_kernel.py::iso_block_grid_cuda``, which the plans'
    binds take for a CUDA volume; this one for a CPU volume."""
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")
    if volume.dim() != 3 or min(volume.shape) < 1:
        raise ValueError(f"expected a non-empty (Z, Y, X) volume, got {tuple(volume.shape)}")
    with span("vr.grid"):
        s = volume if volume.dtype == torch.uint8 else \
            torch.round(torch.clamp(volume.to(torch.float32), 0.0, 1.0) * 255.0).to(torch.uint8)
        out = []
        for reduce, pair in ((torch.amin, torch.minimum), (torch.amax, torch.maximum)):
            r = s
            for axis in range(3):
                r = _footprint_reduce(r, axis, reduce, pair, wrap)
            out.append(r)
        return torch.stack(out, dim=-1).contiguous()


def iso_grid_from_pool(pool: torch.Tensor, slab_map: torch.Tensor, dims) -> torch.Tensor:
    """The block grid from the bytes a pooled march reads
    (``ops/sampling.py::sample_trilinear_slab_pool``, clamp): for the
    anchors of z-block b, the rows z - 8b in [0, 8] (z clamped to Z - 1) of
    slot ``slab_map[0, b]``; of x-block b, both bytes of the pairs
    [8b, 8b + 8); of y-block b, the rows [8b, 8b + 8], clamped.  For a pool
    built from a volume this is :func:`iso_block_grid` of that volume.
    ``pool`` is an int32 pair16 or float32 narrow pool, ``dims`` (X, Y, Z)
    as ``raycast_kernel.pool_dims`` gives them."""
    X, Y, Z = (int(d) for d in dims)
    dev = pool.device
    nbz, nbx = Z // ISO_BLOCK, -(-X // ISO_BLOCK)
    with span("vr.grid"):
        base = ISO_BLOCK * torch.arange(nbz, device=dev)[:, None]
        rows = (base + torch.arange(ISO_BLOCK + 1, device=dev)).clamp(max=Z - 1) - base
        w = pool[slab_map.reshape(-1).to(torch.int64)[:, None], rows]  # (nbz, 9, Y, words)
        if pool.dtype == torch.int32:  # two pairs a word, x even in the low half
            w = torch.stack([w & 0xFFFF, (w >> 16) & 0xFFFF], dim=-1).reshape(
                nbz, ISO_BLOCK + 1, Y, X)
        else:
            w = w.to(torch.int32)
        taps = torch.stack([w >> 8, w & 255], dim=-1).to(torch.uint8)  # s[x], s[x + 1]
        jx = torch.arange(ISO_BLOCK * nbx, device=dev).clamp(max=X - 1)
        out = []
        for reduce, pair in ((torch.amin, torch.minimum), (torch.amax, torch.maximum)):
            r = _footprint_reduce(reduce(taps, dim=(1, 4)), 1, reduce, pair, "clamp")
            out.append(reduce(r.index_select(2, jx).reshape(nbz, -1, nbx, ISO_BLOCK), dim=3))
        return torch.stack(out, dim=-1).contiguous()


def iso_grid_from_mip8(mip8: torch.Tensor, dims, wrap: str = "clamp") -> torch.Tensor:
    """The block grid from per-8^3-block maxima in 0..255 units
    (``raycast_kernel.block_max8``, ``codecs/device.tree_occupancy_mip8``; no
    minima, so the least byte is 0): each block's max taken with its upper
    neighbour on each axis (clamped, or wrapped for "repeat"), which covers
    the texels [8b, 8b + 8].  ``dims`` is (X, Y, Z)."""
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")
    nx, ny, nz = _block_counts(dims)
    if tuple(mip8.shape) != (nz, ny, nx):
        raise ValueError(f"mip8 of shape {tuple(mip8.shape)} is not the (Z/8, Y/8, X/8) = "
                         f"{(nz, ny, nx)} block grid of a volume of (X, Y, Z) = {tuple(dims)}")
    with span("vr.grid"):
        m = torch.clamp(torch.ceil(mip8.to(torch.float32)), 0.0, 255.0)
        for axis in range(3):
            n = m.shape[axis]
            upper = torch.roll(m, -1, axis) if wrap == "repeat" else \
                torch.cat([m.narrow(axis, 1, n - 1), m.narrow(axis, n - 1, 1)], dim=axis)
            m = torch.maximum(m, upper)
        return torch.stack([torch.zeros_like(m), m], dim=-1).to(torch.uint8).contiguous()
