"""Trilinear volume sampling with OpenGL texture semantics (PyTorch).

Counterpart of ``volumerenderer_tpu/ops/sampling.py``: GLSL
``texture(volume, uvw).r`` on an 8-bit 3D texture with linear filtering —
normalized coordinates in [0,1], texel centers at ``(i + 0.5) / N``, byte
values normalized by 255.  ``wrap="clamp"`` clamps the fetched indices to the
edge; ``wrap="repeat"`` wraps the coordinate into [0, 1) first (GL_REPEAT).

The volume is indexed ``[z, y, x]``; ``uvw[..., 0]`` is x.  Every lerp is a
separate multiply and add (no ``torch.lerp``), in the JAX function's order, so
the float32 rounding matches it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_trilinear", "sample_trilinear_slab_pool", "slab_pool_sampler",
           "sample_trilinear_shard", "shard_sampler", "as_sampler", "trilinear_scatter_add_",
           "as_normalized_volume", "WRAP_MODES"]

WRAP_MODES = ("clamp", "repeat")


def as_normalized_volume(volume, device: torch.device | str | None = None) -> torch.Tensor:
    """uint8 volume (Z, Y, X) -> float32 normalized to [0, 1]; a float volume
    is cast to float32 as it is.  Accepts a numpy array or a tensor.

    ``device=None`` places a numpy array on the card ("cuda") and leaves a
    tensor on its own device; any other ``device`` moves the result there."""
    if isinstance(volume, np.ndarray):  # copied only if read-only or strided
        volume = torch.from_numpy(np.require(volume, requirements=["C", "W"]))
        device = "cuda" if device is None else device
    v = volume if device is None else volume.to(device)
    if v.dtype == torch.uint8:
        return v.to(torch.float32) * (1.0 / 255.0)
    return v.to(torch.float32)


def _wrap_index(i: torch.Tensor, n: int, wrap: str) -> torch.Tensor:
    if wrap == "clamp":
        return torch.clamp(i, 0, n - 1)
    return torch.remainder(i, n)


def texel_coords(uvw: torch.Tensor, dims):
    """The texel math of every sampler here: the anchor ``floor(uvw * dims -
    0.5)`` (int64) and the fraction past it, per axis, of positions ``uvw``
    (..., 3) on a volume of ``dims`` = (X, Y, Z)."""
    fdims = torch.tensor([float(d) for d in dims], dtype=torch.float32, device=uvw.device)
    t = uvw * fdims - 0.5
    i0f = torch.floor(t)
    return i0f.to(torch.int64), t - i0f


def trilerp(taps, frac: torch.Tensor) -> torch.Tensor:
    """The seven lerps of the 8 taps (c000, c100, c010, c110, c001, c101,
    c011, c111), x index first: along x, then y, then z, each product and
    sum on its own, in the JAX function's order."""
    c000, c100, c010, c110, c001, c101, c011, c111 = taps
    fx = frac[..., 0]
    fy = frac[..., 1]
    fz = frac[..., 2]
    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def gather_trilerp(flat: torch.Tensor, xs, ys, zs, frac: torch.Tensor) -> torch.Tensor:
    """:func:`trilerp` of the taps ``flat[z + y + x]``, where ``xs``, ``ys``
    and ``zs`` are the (lower, upper) flat offsets of each axis."""
    return trilerp([flat[z + y + x] for z in zs for y in ys for x in xs], frac)


def rebased_taps(i0: torch.Tensor, n: int, lo: int, extent: int, stride: int):
    """The flat offsets of an axis's two taps in a block holding the global
    rows [lo, lo + extent) of that axis: the anchor ``i0`` and ``i0 + 1``
    clamped against the global extent ``n``, then rebased by ``lo`` and
    clamped into the block, times the block's ``stride``."""
    return tuple(torch.clamp(torch.clamp(j, 0, n - 1) - lo, 0, extent - 1) * stride
                 for j in (i0, i0 + 1))


def sample_trilinear(volume: torch.Tensor, uvw: torch.Tensor, wrap: str = "clamp") -> torch.Tensor:
    """Trilinearly sample ``volume`` (Z, Y, X) float32 at ``uvw`` (..., 3) in [0,1].

    Returns (...,) float32 samples.
    """
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")
    Z, Y, X = volume.shape
    if wrap == "repeat":
        uvw = uvw - torch.floor(uvw)
    i0, frac = texel_coords(uvw, (X, Y, Z))

    def taps(i, n, stride):
        return _wrap_index(i, n, wrap) * stride, _wrap_index(i + 1, n, wrap) * stride

    return gather_trilerp(volume.reshape(-1), taps(i0[..., 0], X, 1), taps(i0[..., 1], Y, X),
                          taps(i0[..., 2], Z, X * Y), frac)


def as_sampler(volume, wrap: str = "clamp"):
    """The marches' sampler: a callable ``uvw (..., 3) -> samples (...)``.
    A (Z, Y, X) float32 volume tensor becomes :func:`sample_trilinear` on it
    with ``wrap``; a callable (e.g. :func:`slab_pool_sampler`) is returned
    as it is and samples by its own rules."""
    if isinstance(volume, torch.Tensor):
        if wrap not in WRAP_MODES:
            raise ValueError(f"unknown wrap mode: {wrap}")
        return lambda uvw: sample_trilinear(volume, uvw, wrap=wrap)
    if not callable(volume):
        raise TypeError(f"expected a volume tensor or a sampler, got {type(volume).__name__}")
    return volume


def sample_trilinear_slab_pool(pool: torch.Tensor, slab_map: torch.Tensor, dims,
                               uvw: torch.Tensor) -> torch.Tensor:
    """Clamp-mode :func:`sample_trilinear` of the 8-bit volume a slab pool
    (``ops/cuda/raycast_kernel.py::build_slab_pool`` or
    ``build_slab_pool_narrow``) was built from, fetched from the pool.

    Bit for bit what ``sample_trilinear(as_normalized_volume(vol_u8), uvw,
    "clamp")`` returns: the same index math, taps ``byte * (1/255)`` and the
    same lerps; only the fetch differs.  z-block ``b = z0 >> 3`` reads slot
    ``slab_map[0, b]``, whose 16 rows start at z = 8b, so the rows of both z
    taps are ``z - 8b <= 8``.  A pair holds ``s[x]`` (high byte) and
    ``s[x + 1]`` (low byte, the last x edge-clamped); where the x index
    ``i0x`` is below 0 both x taps clamp to 0, and the high byte serves both.
    ``dims`` is (X, Y, Z).  The pool is (n_slots, 16, Y, X // 2) int32
    pair16 words (two pairs per word, x even in the low half) or
    (n_slots, 16, Y, X) float32 pair values ``s[x]*256 + s[x+1]``.
    """
    X, Y, Z = (int(d) for d in dims)
    i0, frac = texel_coords(uvw, (X, Y, Z))
    ix = i0[..., 0]
    x0 = torch.clamp(ix, 0, X - 1)
    y0 = torch.clamp(i0[..., 1], 0, Y - 1)
    y1 = torch.clamp(i0[..., 1] + 1, 0, Y - 1)
    z0 = torch.clamp(i0[..., 2], 0, Z - 1)
    z1 = torch.clamp(i0[..., 2] + 1, 0, Z - 1)
    block = z0 >> 3
    slot = slab_map.reshape(-1).to(torch.int64)[block]
    base0 = (slot * 16 + (z0 - 8 * block)) * Y
    base1 = (slot * 16 + (z1 - 8 * block)) * Y
    flat = pool.reshape(-1)
    low_edge = ix < 0

    def taps(row):  # (s[x0], s[x1]) of one (z, y) row
        if pool.dtype == torch.int32:
            word = flat[row * (X // 2) + (x0 >> 1)]
            p16 = torch.where((x0 & 1) == 1, (word >> 16) & 0xFFFF, word & 0xFFFF)
        else:
            p16 = flat[row * X + x0].to(torch.int32)
        c0 = (p16 >> 8).to(torch.float32) * (1.0 / 255.0)
        c1 = (p16 & 255).to(torch.float32) * (1.0 / 255.0)
        return c0, torch.where(low_edge, c0, c1)

    return trilerp([c for row in (base0 + y0, base0 + y1, base1 + y0, base1 + y1)
                    for c in taps(row)], frac)


def slab_pool_sampler(pool: torch.Tensor, slab_map: torch.Tensor, dims):
    """:func:`sample_trilinear_slab_pool` on one pool, as a sampler for the
    marches (``ops/raycast.py``, ``ops/isosurface.py``)."""
    return lambda uvw: sample_trilinear_slab_pool(pool, slab_map, dims, uvw)


def sample_trilinear_shard(slab: torch.Tensor, dims, z_lo: int, y_lo: int,
                           uvw: torch.Tensor) -> torch.Tensor:
    """Clamp-mode :func:`sample_trilinear` of the global volume, fetched from
    one shard's halo-extended slab (the plain counterpart of the taps of
    ``csrc/seg_march.cu``).

    ``slab`` (Ez, Ey, X) float32 holds the global rows [z_lo, z_lo + Ez) x
    [y_lo, y_lo + Ey) of a volume of ``dims = (X, Y, Z)``.  The texel math,
    the anchor and both taps of each axis are the dense sampler's, clamped
    against the global (X, Y, Z); only then are the z and y indices rebased
    by (z_lo, y_lo), and clamped into the slab so that any position reads
    inside it.  A shard owns the anchors z0 in [z_lo, z_lo + n_z) and y0 in
    [y_lo, y_lo + n_y), whose taps z0 + 1 and y0 + 1 need one halo plane and
    one halo row (``Ez = n_z + 1``, ``Ey = n_y + 1``, or all Y rows when y is
    not sharded): for every owned anchor the sample is bit for bit the dense
    sampler's on the whole volume.  The JAX segment kernel keeps an 8-row y
    halo (``seg_kernel.py:57``) only so that its TPU DMA windows start on
    8-aligned rows; one row is all the taps read, so the port keeps one.
    """
    X, Y, Z = (int(d) for d in dims)
    Ez, Ey, _ = slab.shape
    i0, frac = texel_coords(uvw, (X, Y, Z))

    return gather_trilerp(slab.reshape(-1), rebased_taps(i0[..., 0], X, 0, X, 1),
                          rebased_taps(i0[..., 1], Y, y_lo, Ey, X),
                          rebased_taps(i0[..., 2], Z, z_lo, Ez, X * Ey), frac)


def shard_sampler(slab: torch.Tensor, dims, z_lo: int, y_lo: int):
    """:func:`sample_trilinear_shard` on one shard's slab, as a sampler for
    the marches (``ops/raycast.py::seg_march_steps``)."""
    return lambda uvw: sample_trilinear_shard(slab, dims, z_lo, y_lo, uvw)


def trilinear_scatter_add_(grad: torch.Tensor, uvw: torch.Tensor, g: torch.Tensor) -> None:
    """Adjoint of clamp-mode :func:`sample_trilinear`: add ``g * w`` into the
    8 taps of each position, in place in ``grad`` (Z, Y, X) float32.

    ``uvw`` is (N, 3) and ``g`` (N,).  The weights are ``g*wz*wy*wx`` in that
    order, z outermost and x innermost, as the JAX package's
    ``diff/vjp.py::_trilinear_scatter`` forms them.  Two taps clamped onto
    the same voxel both add.
    """
    Z, Y, X = grad.shape
    i0, frac = texel_coords(uvw, (X, Y, Z))
    xs = (torch.clamp(i0[:, 0], 0, X - 1), torch.clamp(i0[:, 0] + 1, 0, X - 1))
    ys = (torch.clamp(i0[:, 1], 0, Y - 1) * X, torch.clamp(i0[:, 1] + 1, 0, Y - 1) * X)
    zs = (torch.clamp(i0[:, 2], 0, Z - 1) * (X * Y),
          torch.clamp(i0[:, 2] + 1, 0, Z - 1) * (X * Y))
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    offsets, values = [], []
    for zi, wz in ((zs[0], 1.0 - fz), (zs[1], fz)):
        for yi, wy in ((ys[0], 1.0 - fy), (ys[1], fy)):
            for xi, wx in ((xs[0], 1.0 - fx), (xs[1], fx)):
                offsets.append(zi + yi + xi)
                values.append(g * wz * wy * wx)
    grad.view(-1).index_add_(0, torch.cat(offsets), torch.cat(values))
