"""Front-to-back alpha-compositing ray march — plain PyTorch path.

Counterpart of ``volumerenderer_tpu/ops/raycast.py`` and the plain version of
the CUDA march kernel (``csrc/composite_march.cu``):

* rays start at the cube entry point and advance by
  ``dir_step = direction * (1/X, 1/Y, 1/Z)`` *before* each sample, by repeated
  addition (never ``entry + t * dir_step``);
* up to ``MAX_SAMPLES = 300`` steps;
* a ray stops when any coordinate leaves the open interval (0, 1);
* compositing: ``pa = s - s*a; c += pa*s; a += pa*0.6``;
* early termination at ``a > 0.99``, checked after compositing;
* final fixed transfer: ``r = g = 1 - c``, ``b = 1``.

A ``BlockBound`` (the block grid of ``ops/blockgrid.py``, bound by
``CompositingPlan.bind``) lets the march skip exactly: a sample whose block
of tap anchors reads only zero bytes is 0, and a zero sample composites as a
no-op (``pa = s - s*a = 0``), so it is not taken
(``composite_march_steps(..., bound=)``).

``seg_march_steps`` is the same march on one shard of a volume-sharded
layout (the plain version of ``csrc/seg_march.cu``, B10): it composites only
the samples whose anchor the shard owns, with no early-out, and returns the
ray's affine segment map.  ``seg_entry_table`` is the plain version of that
file's entry table: where each ray's owned steps begin.

Per-ray control flow is a latched ``alive`` mask over whole-image tensor
operations.  Each product and sum is its own operation, so float32 rounding
matches the JAX functions (no fused multiply-add).
"""
from __future__ import annotations

import torch

from .blockgrid import BlockBound, anchor_cells, check_bound
from .sampling import as_sampler

__all__ = ["empty_blocks", "composite_march", "composite_march_early_exit",
           "composite_march_steps",
           "seg_march_steps", "seg_steps", "seg_entry_table", "shard_owned",
           "apply_reference_transfer", "render_compositing", "step_sizes", "MAX_SAMPLES",
           "ALPHA_SCALE", "EARLY_OUT_ALPHA", "BIG_T", "NO_ENTRY"]

MAX_SAMPLES = 300
ALPHA_SCALE = 0.6
EARLY_OUT_ALPHA = 0.99
BIG_T = 1.0e9  # t_first of a ray that a shard owns no sample of
NO_ENTRY = -1  # the entry table's first owned step of a ray that a shard owns none of


def step_sizes(dims, device: torch.device | str) -> torch.Tensor:
    """Per-axis step (1/X, 1/Y, 1/Z) as float32 for ``dims = (X, Y, Z)``."""
    X, Y, Z = dims
    return torch.tensor([1.0 / X, 1.0 / Y, 1.0 / Z], dtype=torch.float32, device=device)


def empty_blocks(bound: BlockBound, uvw: torch.Tensor) -> torch.Tensor:
    """Where the samples at ``uvw`` (..., 3) are 0 by the bound's grid: the
    block of each sample's lower tap anchor reads no byte above 0."""
    return anchor_cells(bound.grid, bound.dims, bound.wrap, uvw)[..., 1] == 0


def composite_march_steps(volume: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                          hit: torch.Tensor, max_samples: int = MAX_SAMPLES,
                          wrap: str = "clamp", early_exit: bool = True,
                          bound: BlockBound | None = None):
    """March rays through ``volume`` (Z, Y, X float32 in [0,1]) by ``dir_step``.

    ``volume`` may also be a sampler (``ops/sampling.py::as_sampler``), e.g.
    ``slab_pool_sampler`` for the pooled march's plain version; ``wrap``
    then does not apply.

    Args:
      entry_uv: (..., 3) cube entry points in texture space.
      dir_step: (..., 3) per-step position increment (direction / dims).
      hit: (...) bool mask of rays that intersect the cube.
      early_exit: stop once every ray has terminated.  The result is the
        same either way, because a terminated ray never changes again.
      bound: a compositing ``BlockBound`` of this volume for ``wrap``, or None.
        With a bound, a sample whose block reads only zero bytes is not
        taken (:func:`empty_blocks`): it is 0 and composites as a no-op, so
        the result is the same bit for bit.

    Returns:
      (color, alpha), both (...) float32.
    """
    if bound is not None:
        Z, Y, X = volume.shape if isinstance(volume, torch.Tensor) else (None,) * 3
        check_bound(bound, None if X is None else (X, Y, Z), wrap)
    shape = entry_uv.shape[:-1]
    pos = entry_uv
    color = torch.zeros(shape, dtype=torch.float32, device=entry_uv.device)
    alpha = torch.zeros(shape, dtype=torch.float32, device=entry_uv.device)
    alive = hit.to(torch.bool)
    sample = as_sampler(volume, wrap)
    for _ in range(max_samples):
        if early_exit and not bool(alive.any()):
            break
        pos = pos + dir_step
        inside = ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
        alive = alive & inside
        if bound is None:
            s = sample(pos)
        else:  # only the alive samples of occupied blocks are taken
            take = alive & ~empty_blocks(bound, pos)
            s = torch.zeros(shape, dtype=torch.float32, device=entry_uv.device)
            if bool(take.any()):
                s[take] = sample(pos[take])
        prev_alpha = s - s * alpha
        color = torch.where(alive, color + prev_alpha * s, color)
        alpha = torch.where(alive, alpha + prev_alpha * ALPHA_SCALE, alpha)
        alive = alive & (alpha <= EARLY_OUT_ALPHA)
    return color, alpha


def shard_owned(pos: torch.Tensor, dims, box) -> torch.Tensor:
    """Whether each position's trilinear anchor cell lies in a shard's owned
    box: the clamped floor anchors ``z0 = clamp(floor(w*Z - 0.5), 0, Z - 1)``
    and ``y0`` likewise, in [z_lo, z_hi) x [y_lo, y_hi) (``box``, global
    texel indices; ``dims`` is (X, Y, Z)).  The criterion of the JAX segment
    kernel (``seg_kernel.py:149-156``)."""
    X, Y, Z = dims
    z_lo, z_hi, y_lo, y_hi = box
    z0 = torch.clamp(torch.floor(pos[..., 2] * float(Z) - 0.5), 0.0, Z - 1.0)
    y0 = torch.clamp(torch.floor(pos[..., 1] * float(Y) - 0.5), 0.0, Y - 1.0)
    return (z0 >= z_lo) & (z0 < z_hi) & (y0 >= y_lo) & (y0 < y_hi)


def seg_steps(entry_uv: torch.Tensor, dir_step: torch.Tensor, hit: torch.Tensor, dims, box,
              max_samples: int = MAX_SAMPLES, starts: torch.Tensor | None = None):
    """The steps of the segment march on one shard: yields ``(pos, comp,
    t)`` per step, ``comp`` the rays that composite there (alive and owned,
    :func:`shard_owned`) and ``t`` their 0-based step index (a float, or a
    float32 tensor per ray).

    Without ``starts`` every ray walks from ``entry_uv`` by repeated ``pos +
    dir_step`` while ``hit``, inside (0, 1)^3 and short of ``max_samples``
    steps.  With ``starts`` (the entry of :func:`seg_entry_table`) each ray
    starts at its first owned step and stops where it leaves the owned
    interval: the same positions from the same additions, hence the same
    samples.  A ray's owned steps form one interval, because positions built
    by repeated addition move monotonically along each axis (float addition
    is monotone), and so do their clamped floor anchors.
    """
    if starts is None:
        pos, alive = entry_uv, hit.to(torch.bool)
        for t in range(max_samples):
            if not bool(alive.any()):
                break
            pos = pos + dir_step
            alive = alive & ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
            yield pos, alive & shard_owned(pos, dims, box), float(t)
        return
    pos = starts[..., :3]
    step = starts[..., 3].contiguous().view(torch.int32)
    alive = step != NO_ENTRY
    while bool(alive.any()):
        alive = alive & (step < max_samples)
        pos = pos + dir_step
        alive = alive & ((pos > 0.0) & (pos < 1.0)).all(dim=-1) & shard_owned(pos, dims, box)
        yield pos, alive, step.to(torch.float32)
        step = step + 1


def seg_march_steps(volume, entry_uv: torch.Tensor, dir_step: torch.Tensor, hit: torch.Tensor,
                    dims, box, max_samples: int = MAX_SAMPLES,
                    starts: torch.Tensor | None = None):
    """The compositing march on one volume shard: the segment map of each ray.

    ``volume`` is a sampler of the global volume (``ops/sampling.py::
    shard_sampler`` on the shard's slab) or a (Z, Y, X) float32 volume;
    ``dims`` is (X, Y, Z) and ``box`` = (z_lo, z_hi, y_lo, y_hi) the owned
    anchor box (:func:`shard_owned`).  Positions advance by repeated
    ``pos + dir_step``; a ray is alive while ``hit``, inside (0, 1)^3 and
    short of ``max_samples`` steps, and a sample composites only where the
    ray is alive and the shard owns it.  There is no early-out: a shard
    cannot see the ray's global alpha.  With ``starts`` (the entry of
    :func:`seg_entry_table` for these rays and box) each ray starts at its
    first owned step, with the same result (:func:`seg_steps`).

    Returns (C_seg, alpha_seg, t_first), each (...) float32: under the
    compositing recurrence the segment acts on (color, transmittance) as
    ``c -> c + tau*C_seg``, ``tau -> tau*(1 - alpha_seg)``; ``t_first`` is
    the least owned step index (0-based, the first sample at ``entry +
    dir_step``), ``BIG_T`` where the shard owns none.
    """
    shape = entry_uv.shape[:-1]
    color = torch.zeros(shape, dtype=torch.float32, device=entry_uv.device)
    alpha = torch.zeros_like(color)
    t_first = torch.full_like(color, BIG_T)
    sample = as_sampler(volume)
    for pos, comp, t in seg_steps(entry_uv, dir_step, hit, dims, box, max_samples, starts):
        s = sample(pos)
        prev_alpha = s - s * alpha
        color = torch.where(comp, color + prev_alpha * s, color)
        alpha = torch.where(comp, alpha + prev_alpha * ALPHA_SCALE, alpha)
        t_first = torch.where(comp, torch.clamp(t_first, max=t), t_first)
    return color, alpha, t_first


def seg_entry_table(entry_uv: torch.Tensor, dir_step: torch.Tensor, hit: torch.Tensor, dims,
                    box, max_samples: int = MAX_SAMPLES) -> torch.Tensor:
    """Where each ray's owned steps begin on one shard: the plain version of
    the entry table of ``csrc/seg_march.cu``, which takes the place of the
    JAX package's ``build_word_table_seg`` group skip.

    Replays the march's recurrence (:func:`seg_steps` without ``starts``)
    until each ray leaves the cube or its ``max_samples`` steps, or reaches
    its first owned step.  It depends on the rays and the box, not on the
    volume.

    Returns (..., 4) float32: per ray, the position after ``i0`` additions,
    so that the march's next ``pos + dir_step`` lands on the first owned
    sample, then the int32 bits of ``i0``, the first owned step index
    (``NO_ENTRY`` and a zero position where the shard owns none).
    """
    start = torch.zeros_like(entry_uv)
    i0 = torch.full(entry_uv.shape[:-1], NO_ENTRY, dtype=torch.int32, device=entry_uv.device)
    pos, alive = entry_uv, hit.to(torch.bool)
    for t in range(max_samples):
        if not bool(alive.any()):
            break
        prev, pos = pos, pos + dir_step
        alive = alive & ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
        first = alive & shard_owned(pos, dims, box)
        start = torch.where(first[..., None], prev, start)
        i0 = torch.where(first, t, i0)
        alive = alive & ~first
    return torch.cat([start, i0.view(torch.float32)[..., None]], dim=-1)


def composite_march(volume, entry_uv, direction, hit, max_samples: int = MAX_SAMPLES,
                    wrap: str = "clamp"):
    """Fixed-trip march of ``max_samples`` steps.  ``direction`` (..., 3) is
    the normalized ray direction.  Returns (color, alpha); apply
    :func:`apply_reference_transfer` for the displayed RGB."""
    Z, Y, X = volume.shape
    dir_step = direction * step_sizes((X, Y, Z), direction.device)
    return composite_march_steps(volume, entry_uv, dir_step, hit, max_samples, wrap,
                                 early_exit=False)


def composite_march_early_exit(volume, entry_uv, direction, hit,
                               max_samples: int = MAX_SAMPLES, wrap: str = "clamp"):
    """Same result as :func:`composite_march`; stops as soon as every ray has
    terminated (bounds exit or alpha saturation)."""
    Z, Y, X = volume.shape
    dir_step = direction * step_sizes((X, Y, Z), direction.device)
    return composite_march_steps(volume, entry_uv, dir_step, hit, max_samples, wrap,
                                 early_exit=True)


def apply_reference_transfer(color: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The reference's fixed color transfer: r = 1 - c, g = 1 - c, b = 1
    (255 saturates in the framebuffer).  ``alpha`` is unused, as in the
    reference shader."""
    inv = 1.0 - color
    return torch.stack([inv, inv, torch.ones_like(color)], dim=-1)


def render_compositing(volume, entry_uv, direction, hit, max_samples: int = MAX_SAMPLES,
                       wrap: str = "clamp", early_exit: bool = True):
    """Full reference pipeline: march + fixed transfer.  Returns (rgb, alpha)
    where rgb is (..., 3) in [0, 1] (missed rays come out white)."""
    march = composite_march_early_exit if early_exit else composite_march
    color, alpha = march(volume, entry_uv, direction, hit, max_samples, wrap)
    return apply_reference_transfer(color, alpha), alpha
