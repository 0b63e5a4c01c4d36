"""The 8^3 block grid of a CUDA volume in one pass: the launch wrapper of
``csrc/block_grid.cu``, the grid the bound marches read, and
:func:`bind_grid`, the one bind of both plans.

``IsosurfacePlan.bind`` and ``CompositingPlan.bind`` both call
:func:`bind_grid`, which builds a volume's grid through
:func:`volume_block_grid`: this kernel for a CUDA volume,
``ops/blockgrid.py::iso_block_grid``, its plain version, for a CPU one; the
two are equal bit for bit.  :func:`bind_grid` keeps each grid it built for
as long as its data lives, and hands it to later binds of the same,
unchanged tensors: a sweep of isovalues over one volume builds once.  The
JAX package builds its bind tables in jnp, so the kernel replaces no Pallas
kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ...utils.timer import span
from ..blockgrid import (ISO_BLOCK, BlockBound, data_source, iso_block_grid, iso_grid_from_mip8,
                         iso_grid_from_pool)
from ..sampling import WRAP_MODES
from . import _build
from ._launch import (bind, check_clamp, check_shape, check_volume, count_launch, dense_entry,
                      launch, pool_dims)

__all__ = ["iso_block_grid_cuda", "volume_block_grid", "bind_grid", "load_kernel"]


@functools.cache
def _launcher(entry: str):
    # vol, cells; X, Y, Z, repeat; row stride, plane stride, stream
    return bind("block_grid", 2, 4, [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p],
                entry=entry)


def load_kernel() -> _build.BuiltLibrary:
    """Build (at first use) and load the grid kernel's library."""
    return _launcher("block_grid")[1]


def iso_block_grid_cuda(volume: torch.Tensor, wrap: str = "clamp") -> torch.Tensor:
    """``iso_block_grid`` of a CUDA volume, by one kernel launch that reads
    each texel about once: the (ceil(Z/8), ceil(Y/8), ceil(X/8), 2) uint8
    grid, per block b the least and the largest byte over the texels [8b,
    8b + 8] of each axis (clamped, or wrapped for "repeat").  A (Z, Y, X)
    uint8 volume is read as its bytes, a float32 one quantized as it is read
    (``round(clamp(v, 0, 1) * 255)``, ties to even); any other dtype is
    converted to float32 first, as the plain version converts it.  Views
    whose x stride is 1 are read in place; others are copied contiguous
    first.  A CPU tensor raises: ``iso_block_grid`` is its version.  The
    call is one ``vr.grid`` span and adds one to
    ``iso_block_grid_cuda.launches`` (and, for the float32 route, to its
    ``f32_launches``)."""
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")
    if volume.dim() != 3 or min(volume.shape) < 1:
        raise ValueError(f"expected a non-empty (Z, Y, X) volume, got {tuple(volume.shape)}")
    if volume.device.type != "cuda":
        raise ValueError(f"iso_block_grid_cuda takes a CUDA volume, got one on {volume.device}; "
                         f"iso_block_grid is the version for the CPU")
    with span("vr.grid"):
        if volume.dtype not in (torch.uint8, torch.float32):
            volume = volume.to(torch.float32)
        if volume.stride(2) != 1 and volume.shape[2] > 1:
            volume = volume.contiguous()
        check_volume(volume, volume.dtype, "volume")
        Z, Y, X = volume.shape
        grid = torch.empty([-(-n // ISO_BLOCK) for n in (Z, Y, X)] + [2], dtype=torch.uint8,
                           device=volume.device)
        entry = dense_entry("block_grid", volume)
        launch(lambda: _launcher(entry), "block_grid", volume.device, volume.data_ptr(),
               grid.data_ptr(), X, Y, Z, int(wrap == "repeat"), volume.stride(1),
               volume.stride(0))
        count_launch(iso_block_grid_cuda, volume)
        return grid


iso_block_grid_cuda.launches = 0
iso_block_grid_cuda.f32_launches = 0


def volume_block_grid(volume: torch.Tensor, wrap: str = "clamp") -> torch.Tensor:
    """The block grid of ``volume`` where it lies: the plain
    ``iso_block_grid`` for a CPU tensor, :func:`iso_block_grid_cuda` for any
    other (which raises unless it is a CUDA tensor)."""
    if volume.device.type == "cpu":
        return iso_block_grid(volume, wrap)
    return iso_block_grid_cuda(volume, wrap)


@dataclasses.dataclass(eq=False)
class _Built:
    """A grid :func:`bind_grid` built: weak references to the tensors it was
    computed from past the first (the cache's key), each tensor's
    :func:`_stamp` then, the grid and its own version, and, once a
    compositing bind has asked, whether it holds a block to skip."""

    refs: tuple
    stamps: tuple
    grid: torch.Tensor
    grid_version: int
    has_empty: bool | None = None


# first data tensor -> {(route, wrap, device): _Built}; an entry goes with its tensor
_built = WeakIdKeyDictionary()


def _stamp(t: torch.Tensor):
    """What a tensor shows that an in-place write or a new storage changes:
    its version counter, data pointer, shape, strides, dtype and device.
    None for an inference-mode tensor, which has no version counter."""
    if t.is_inference():
        return None
    return t._version, t.data_ptr(), t.shape, t.stride(), t.dtype, t.device


def _reusable(built: _Built | None, tensors, stamps) -> bool:
    return (built is not None and None not in stamps and built.stamps == stamps
            and all(r() is t for r, t in zip(built.refs, tensors[1:]))
            and built.grid._version == built.grid_version)


def bind_grid(dims, wrap: str, device, volume: torch.Tensor | None = None, pool=None,
              mip8: torch.Tensor | None = None, iso: float | None = None) -> BlockBound:
    """The bound of a plan's marches over exactly one of ``volume`` ((Z, Y,
    X) of ``dims`` = (X, Y, Z), float32 in [0, 1] or uint8) and ``pool`` (a
    ``(pool, slab_map)`` pair holding such a volume; clamp only), for
    ``wrap``: its block grid from that data's bytes, or, given ``mip8``
    (per-8^3-block maxima of the same data), from the mip, with no pass over
    the data; the grid put on ``device``; the data's identity
    (``data_source``).  ``iso`` is the isovalue of an isosurface bind (None
    for a compositing one): a compositing bound records whether its grid
    holds a block to skip (``has_empty``).

    The grid depends only on the data and the wrap, so a bind reuses the
    grid an earlier bind built from the very same tensors (the volume; the
    pool and its map; and the mip, where one is given) for the same wrap,
    route and ``device``, as long as none of them has been written since:
    each tensor's version counter, data pointer, shape, strides and dtype
    are what they were at the build.  Any in-place torch write, directly or
    through a view, bumps the version, and a new tensor with equal bytes is
    other data: both build anew, and the new grid replaces the old.  The
    version counter does not see writes made outside torch's in-place ops
    (through ``.data``, a numpy array sharing the memory, DLPack or a raw
    pointer): after such a write, bind a new tensor.  A mip in inference
    mode has no version counter, so its binds always build.  The grids are
    held no longer than their data (a weak reference); each bind returns a
    bound of its own around the shared grid.  A build adds one to
    ``bind_grid.builds``, a reuse one to ``bind_grid.hits``; only a build
    is a ``vr.grid`` span."""
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")
    if (volume is None) == (pool is None):
        raise ValueError("bind takes a volume or a (pool, slab_map) pair, exactly one of the two")
    if volume is not None:
        check_shape(volume, dims)
        data = (volume,)
    else:
        check_clamp(wrap, "pooled binds")
        data = tuple(pool)
        if len(data) != 2 or pool_dims(*data) != dims:
            raise ValueError(f"pool must be a (pool, slab_map) pair holding a volume of "
                             f"(X, Y, Z) = {dims}")
    source = data_source(*data)
    tensors = data if mip8 is None else data + (mip8,)
    route = "mip8" if mip8 is not None else "volume" if volume is not None else "pool"
    stamps = tuple(_stamp(t) for t in tensors)
    per_data = _built.setdefault(data[0], {})
    built = per_data.get((route, wrap, device))
    if _reusable(built, tensors, stamps):
        bind_grid.hits += 1
    else:
        if mip8 is not None:
            grid = iso_grid_from_mip8(mip8, dims, wrap)
        elif volume is not None:
            grid = volume_block_grid(volume, wrap)
        else:
            grid = iso_grid_from_pool(*data, dims)
        grid = grid.to(device)
        built = _Built(tuple(weakref.ref(t) for t in tensors[1:]), stamps, grid, grid._version)
        per_data[route, wrap, device] = built
        bind_grid.builds += 1
    if iso is None and built.has_empty is None:
        built.has_empty = bool((built.grid[..., 1] == 0).any())
    return BlockBound(dims, wrap, built.grid, source, iso is not None or built.has_empty,
                      None if iso is None else float(iso))


bind_grid.builds = 0
bind_grid.hits = 0
