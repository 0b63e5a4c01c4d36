"""Phong-shaded isosurface ray march — plain PyTorch path.

Counterpart of ``volumerenderer_tpu/ops/isosurface.py`` (the reference's
``isosurface.frag:77-158``) and the plain version of the two CUDA kernels:

* :func:`iso_march_steps` (kernel ``csrc/iso_march.cu``): the compositing
  march's setup (entry at the cube, ``pos += dir_step`` before each sample,
  300 steps, open-interval bounds exit) with the zero-crossing test
  ``(s - iso) < 0 && (s2 - iso) >= 0`` between the sample at ``pos`` and the
  lookahead at ``pos + dir_step``.  It returns ``found`` and ``t_hit = i - 1``
  for a crossing at step ``i`` (-1 for a miss), and with ``with_near`` the
  position ``pos_i`` it held there;
* :func:`shade_hits` (kernel ``csrc/iso_shade.cu``): the bracket
  ``[pos_i, pos_i + dir_step]``, ``pos_i`` as the march returned it or
  rebuilt by ``t_hit + 1`` repeated additions, a 4-step bisection, the
  ``DELTA = 0.01`` central-difference normal and the headlight Phong term
  (specular power 250, diffuse (0.39, 0.58, 0.93)), clipped to [0, 1];
  missed rays are white.

A ``BlockBound`` made for an isovalue (``iso_block_grid``,
``iso_grid_from_pool``, ``iso_grid_from_mip8``, in ``ops/blockgrid.py``)
lets the march skip exactly: per 8^3 block of tap anchors the least and
largest byte its trilinear taps can read, so a lookahead whose block lies
wholly below or above the isovalue is not sampled
(``iso_march_steps(..., bound=)``).

``render_isosurface`` is exactly the two composed.  As in ``ops/raycast.py``
each product and sum is its own tensor operation, the three-term dot products
add left to right, and the isovalue is rounded once to float32, so the
kernels can be held bit for bit against these functions.  Vector lengths
follow XLA's rounding of ``jnp.linalg.norm`` (see ``_norm``).
"""
from __future__ import annotations

import torch

from .blockgrid import (ISO_BLOCK, BlockBound, anchor_cells, check_bound, data_source,
                        iso_block_grid, iso_grid_from_mip8, iso_grid_from_pool)
from .raycast import step_sizes
from .sampling import as_sampler

__all__ = ["render_isosurface", "iso_march_steps", "shade_hits", "bisection_refine",
           "gradient_normal", "phong", "iso_block_grid", "iso_grid_from_pool",
           "iso_grid_from_mip8", "classify_blocks", "data_source", "MAX_SAMPLES", "DELTA", "SPEC_POWER", "DIFFUSE", "ISO_BLOCK"]

MAX_SAMPLES = 300       # isosurface.frag:15
DELTA = 0.01            # isosurface.frag:18
SPEC_POWER = 250.0      # isosurface.frag:155
DIFFUSE = (0.39, 0.58, 0.93)  # isosurface.frag:155


def _f32(x, device) -> torch.Tensor:
    """A python number or tensor as a float32 scalar tensor on ``device``
    (rounded once, as ``jnp.asarray(x, float32)`` rounds it)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Three-term dot product over the last axis, added left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis, rounded as XLA computes
    ``jnp.linalg.norm``: ``v0*v0``, then the other two squares added by fused
    multiply-adds, then the square root (``fmaf`` in the kernel).  Each
    multiply-add runs in float64, where the product of two float32 values is
    exact, and is then rounded to float32: the fused result, unless the
    float64 sum rounds too (one term below 2^-29 of the other) and lands on a
    float32 tie."""
    v64 = v.to(torch.float64)
    acc = v[..., 0] * v[..., 0]
    acc = (v64[..., 1] * v64[..., 1] + acc.to(torch.float64)).to(torch.float32)
    acc = (v64[..., 2] * v64[..., 2] + acc.to(torch.float64)).to(torch.float32)
    return torch.sqrt(acc)


def bisection_refine(volume, left, right, iso, wrap: str = "clamp"):
    """4-iteration bisection between ``left`` and ``right`` (``isosurface.frag:23-42``).
    ``volume`` is a volume tensor or a sampler (``ops/sampling.py::as_sampler``)."""
    iso = _f32(iso, left.device)
    sample = as_sampler(volume, wrap)
    for _ in range(4):
        mid = (right + left) * 0.5
        go_left = (sample(mid) < iso)[..., None]
        left = torch.where(go_left, mid, left)
        right = torch.where(go_left, right, mid)
    return (right + left) * 0.5


def gradient_normal(volume, uvw, wrap: str = "clamp"):
    """Central-difference normal, ``normalize((s1 - s2) / 2)`` (``isosurface.frag:47-62``).
    ``volume`` is a volume tensor or a sampler (``ops/sampling.py::as_sampler``)."""
    offsets = torch.eye(3, dtype=torch.float32, device=uvw.device) * DELTA
    sample = as_sampler(volume, wrap)
    s1 = torch.stack([sample(uvw - offsets[i]) for i in range(3)], dim=-1)
    s2 = torch.stack([sample(uvw + offsets[i]) for i in range(3)], dim=-1)
    g = (s1 - s2) / 2.0
    norm = _norm(g)[..., None]
    return g / torch.where(norm > 0, norm, torch.ones_like(norm))


def phong(L, N, V, spec_power: float = SPEC_POWER, diffuse_color=DIFFUSE):
    """``PhongLighting`` (``isosurface.frag:69-75``)."""
    diffuse = torch.clamp_min(_dot(L, N), 0.0)
    half_vec = L + V
    half_vec = half_vec / _norm(half_vec)[..., None]
    spec = torch.pow(torch.maximum(_f32(1e-5, N.device), _dot(half_vec, N)), spec_power)
    color = torch.tensor(diffuse_color, dtype=torch.float32, device=N.device)
    return diffuse[..., None] * color + spec[..., None]


def classify_blocks(bound: BlockBound, uvw: torch.Tensor):
    """(below, above) masks of the samples at ``uvw`` (..., 3): the block of
    each sample's lower tap anchor (the sampler's own texel math, the
    anchor clamped or wrapped onto the volume) lies wholly below the
    isovalue (``max + 0.5 < iso * 255``) or wholly at or above it
    (``min - 0.5 >= iso * 255``); where neither holds the block is mixed.
    The half-byte margin is far wider than the ulps by which a float32 lerp
    may leave its taps' range, so a sample of a below block is below iso
    and one of an above block is not."""
    cell = anchor_cells(bound.grid, bound.dims, bound.wrap, uvw).to(torch.float32)
    iso255 = _f32(bound.iso, uvw.device) * 255.0
    return cell[..., 1] + 0.5 < iso255, cell[..., 0] - 0.5 >= iso255


def iso_march_steps(volume: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                    hit: torch.Tensor, iso, max_samples: int = MAX_SAMPLES,
                    wrap: str = "clamp", bound: BlockBound | None = None,
                    with_near: bool = False):
    """March rays through ``volume`` (Z, Y, X float32 in [0,1]) to the first
    upward crossing of ``iso``.  ``volume`` may also be a sampler
    (``ops/sampling.py::as_sampler``); ``wrap`` then does not apply.

    Args:
      entry_uv: (..., 3) cube entry points in texture space.
      dir_step: (..., 3) per-step position increment (direction / dims).
      hit: (...) bool mask of rays that intersect the cube.
      bound: a ``BlockBound`` of this volume for ``iso`` and ``wrap``,
        or None.  With a bound, a sample whose block is wholly below or
        above iso is not taken (:func:`classify_blocks`), and only its side
        of iso is carried: the result is the same bit for bit.

    Returns (found (...) bool, t_hit (...) int32): a crossing at step ``i``
    (1-based) gives ``t_hit = i - 1``; a miss gives -1.  With ``with_near``
    also near (..., 3) float32: for a hit the position at the crossing,
    ``entry_uv`` plus ``t_hit + 1`` repeated additions of ``dir_step`` (the
    bracket :func:`shade_hits` bisects), for a miss ``entry_uv``.  Stops once
    every ray has hit or left the cube (the result is the same as marching
    on).
    """
    if bound is not None:
        Z, Y, X = volume.shape if isinstance(volume, torch.Tensor) else (None,) * 3
        check_bound(bound, None if X is None else (X, Y, Z), wrap, iso)
    iso = _f32(iso, entry_uv.device)
    shape = entry_uv.shape[:-1]
    found = torch.zeros(shape, dtype=torch.bool, device=entry_uv.device)
    t_hit = torch.full(shape, -1, dtype=torch.int32, device=entry_uv.device)
    alive = hit.to(torch.bool)
    sample = as_sampler(volume, wrap)

    def below(uvw, alive):
        # the crossing test needs only each sample's side: (s - iso) < 0
        if bound is None:
            return (sample(uvw) - iso) < 0.0
        side, above = classify_blocks(bound, uvw)
        mixed = alive & ~side & ~above
        if bool(mixed.any()):
            side[mixed] = (sample(uvw[mixed]) - iso) < 0.0
        return side

    pos = near = entry_uv
    was_below = None
    for i in range(1, max_samples + 1):
        if not bool(alive.any()):
            break
        pos = pos + dir_step
        alive = alive & ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
        if was_below is None:
            was_below = below(pos, alive)
        # the lookahead is the next step's sample: pos_{i+1} = pos_i + dir_step
        is_below = below(pos + dir_step, alive)
        crossing = alive & was_below & ~is_below
        t_hit = torch.where(crossing, i - 1, t_hit)
        if with_near:
            near = torch.where(crossing[..., None], pos, near)
        found = found | crossing
        alive = alive & ~crossing
        was_below = is_below
    return (found, t_hit, near) if with_near else (found, t_hit)


def shade_hits(volume: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
               direction: torch.Tensor, found: torch.Tensor, t_hit: torch.Tensor | None, iso,
               wrap: str = "clamp", near: torch.Tensor | None = None):
    """Shade the rays the march found: bisection in the bracket
    ``[near, near + dir_step]`` with ``near`` = ``t_hit + 1`` additions of
    ``dir_step`` to ``entry_uv``, the central-difference normal and the
    headlight Phong term with ``V = -direction``, clipped to [0, 1].  Returns
    (..., 3) rgb; rays without ``found`` are white.  ``volume`` is a volume
    tensor or a sampler (``ops/sampling.py::as_sampler``), as JAX's
    ``_shade_impl`` is generic in its sampler.  Given ``near`` (the march's,
    ``iso_march_steps(..., with_near=True)``; read for the hit rays alone),
    the bracket is taken from it and ``t_hit`` is not read: the same result,
    with no additions repeated."""
    found = found.to(torch.bool)
    if near is not None:
        near = torch.where(found[..., None], near, entry_uv)
    else:
        n_add = torch.where(found, t_hit.to(torch.int64) + 1, 0)
        near = entry_uv
        for k in range(1, int(n_add.max()) + 1 if n_add.numel() else 1):
            near = torch.where((n_add >= k)[..., None], near + dir_step, near)
    tc = bisection_refine(volume, near, near + dir_step, iso, wrap=wrap)
    N = gradient_normal(volume, tc, wrap=wrap)
    V = -direction
    color = torch.clamp(phong(V, N, V), 0.0, 1.0)  # framebuffer saturation
    return torch.where(found[..., None], color, torch.ones_like(color))


def render_isosurface(volume: torch.Tensor, entry_uv: torch.Tensor, direction: torch.Tensor,
                      hit: torch.Tensor, iso_value=40.0 / 255.0,
                      max_samples: int = MAX_SAMPLES, wrap: str = "clamp"):
    """Full reference pipeline: march + shade.  Returns (rgb (..., 3), found
    (...) bool); non-hit pixels are white."""
    Z, Y, X = volume.shape
    dir_step = direction * step_sizes((X, Y, Z), direction.device)
    found, _, near = iso_march_steps(volume, entry_uv, dir_step, hit, iso_value, max_samples,
                                     wrap, with_near=True)
    rgb = shade_hits(volume, entry_uv, dir_step, direction, found, None, iso_value, wrap,
                     near=near)
    return rgb, found
