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

__all__ = ["sample_trilinear", "sample_trilinear_slab_pool", "slab_pool_sampler", "as_sampler",
           "trilinear_scatter_add_", "as_normalized_volume", "WRAP_MODES"]

WRAP_MODES = ("clamp", "repeat")


def as_normalized_volume(volume, device: torch.device | str | None = None) -> torch.Tensor:
    """uint8 volume (Z, Y, X) -> float32 normalized to [0, 1]; a float volume
    is cast to float32 as it is.  Accepts a numpy array or a tensor."""
    if isinstance(volume, np.ndarray):  # copied only if read-only or strided
        volume = torch.from_numpy(np.require(volume, requirements=["C", "W"]))
    v = volume if device is None else volume.to(device)
    if v.dtype == torch.uint8:
        return v.to(torch.float32) * (1.0 / 255.0)
    return v.to(torch.float32)


def _wrap_index(i: torch.Tensor, n: int, wrap: str) -> torch.Tensor:
    if wrap == "clamp":
        return torch.clamp(i, 0, n - 1)
    return torch.remainder(i, n)


def sample_trilinear(volume: torch.Tensor, uvw: torch.Tensor, wrap: str = "clamp") -> torch.Tensor:
    """Trilinearly sample ``volume`` (Z, Y, X) float32 at ``uvw`` (..., 3) in [0,1].

    Returns (...,) float32 samples.
    """
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")
    Z, Y, X = volume.shape
    dims = torch.tensor([X, Y, Z], dtype=torch.float32, device=uvw.device)

    if wrap == "repeat":
        uvw = uvw - torch.floor(uvw)

    t = uvw * dims - 0.5  # texel-space coordinate of the sample
    i0f = torch.floor(t)
    frac = t - i0f
    i0 = i0f.to(torch.int64)
    i1 = i0 + 1

    x0 = _wrap_index(i0[..., 0], X, wrap)
    x1 = _wrap_index(i1[..., 0], X, wrap)
    y0 = _wrap_index(i0[..., 1], Y, wrap) * X
    y1 = _wrap_index(i1[..., 1], Y, wrap) * X
    z0 = _wrap_index(i0[..., 2], Z, wrap) * (X * Y)
    z1 = _wrap_index(i1[..., 2], Z, wrap) * (X * Y)

    fx = frac[..., 0]
    fy = frac[..., 1]
    fz = frac[..., 2]

    flat = volume.reshape(-1)
    c000 = flat[z0 + y0 + x0]
    c100 = flat[z0 + y0 + x1]
    c010 = flat[z0 + y1 + x0]
    c110 = flat[z0 + y1 + x1]
    c001 = flat[z1 + y0 + x0]
    c101 = flat[z1 + y0 + x1]
    c011 = flat[z1 + y1 + x0]
    c111 = flat[z1 + y1 + x1]

    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


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
    fdims = torch.tensor([X, Y, Z], dtype=torch.float32, device=uvw.device)
    t = uvw * fdims - 0.5
    i0f = torch.floor(t)
    frac = t - i0f
    i0 = i0f.to(torch.int64)
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

    c000, c100 = taps(base0 + y0)
    c010, c110 = taps(base0 + y1)
    c001, c101 = taps(base1 + y0)
    c011, c111 = taps(base1 + y1)

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


def slab_pool_sampler(pool: torch.Tensor, slab_map: torch.Tensor, dims):
    """:func:`sample_trilinear_slab_pool` on one pool, as a sampler for the
    marches (``ops/raycast.py``, ``ops/isosurface.py``)."""
    return lambda uvw: sample_trilinear_slab_pool(pool, slab_map, dims, uvw)


def trilinear_scatter_add_(grad: torch.Tensor, uvw: torch.Tensor, g: torch.Tensor) -> None:
    """Adjoint of clamp-mode :func:`sample_trilinear`: add ``g * w`` into the
    8 taps of each position, in place in ``grad`` (Z, Y, X) float32.

    ``uvw`` is (N, 3) and ``g`` (N,).  The weights are ``g*wz*wy*wx`` in that
    order, z outermost and x innermost, as the JAX package's
    ``diff/vjp.py::_trilinear_scatter`` forms them.  Two taps clamped onto
    the same voxel both add.
    """
    Z, Y, X = grad.shape
    dims = torch.tensor([X, Y, Z], dtype=torch.float32, device=uvw.device)
    t = uvw * dims - 0.5
    i0f = torch.floor(t)
    frac = t - i0f
    i0 = i0f.to(torch.int64)
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
