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

__all__ = ["sample_trilinear", "trilinear_scatter_add_", "as_normalized_volume", "WRAP_MODES"]

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
