"""Rendering straight from the compressed kd-tree.

Counterpart of ``volumerenderer_tpu/models/compressed.py``.  The packed tree
lives on the device; a level cut decodes there (``codecs/device.py``), once
per cut; and the render reads either the dense cut (``render``,
``make_plan(pooled=False)``) or only the sparse, deduplicated z-slab pool
built from it (``make_plan(pooled=True)``: the pooled kernels B6–B9 and the
pooled shade, ``ops/cuda/``).

Departures from the JAX class, on purpose:

* ``_decoded`` has no host fallback (and so no per-tree ``_spec_key`` memo
  of failed decodes).  The JAX class takes every ``XlaRuntimeError`` for an
  out-of-memory compile and quietly decodes on the host instead.  Here deep
  trees decode in chunks from the start, so the compile-temp blow-up that
  fallback worked around cannot happen, and a ``torch.cuda.OutOfMemoryError``,
  or any other error, propagates.
* ``make_plan(skip_empty=True)`` binds once, at plan time, as the JAX
  method does, but not both modes from the tree's ``mip8``: compositing
  binds from it (``CompositingPlan.bind(..., mip8=)``; the compositing skip
  needs only block maxima), the isosurface from the data it renders, the
  pool or the dense cut (``IsosurfacePlan.bind``): a max-only grid skips
  only blocks wholly below the isovalue, and at the median that bound
  march was slower than none on the card.  Every bound records the data it
  was made from, so the plan's callable renders only that data.
* The isosurface plan shades from the slab pool it marched, so there is no
  ``shade_pool_at``.
* A cut decodes once for everything drawn from it: a slab pool takes the
  cut's block maxima from the decode it packs (``block_max8``, the same
  grid as ``tree_occupancy_mip8`` by definition) and keeps them for
  ``mip8_at``, and ``mip8_at`` takes them from a cached dense cut.  The JAX
  class decodes a deep tree's cut for its block maxima and again for its
  pool.
* ``self.tree`` keeps the tree's header but not its code arrays, which
  ``self.dtree`` holds packed: a tree built on the device
  (``device_build.build_device``) is packed there, and at 2^31 leaves its
  arrays are 20 GB beside the 5.4 GB packed.

A tree's file I/O is the codec's (``codecs.kdtree.save``,
``open_tree_full``): a tree opened from a checkpoint renders here as the
tree that was saved.
"""
from __future__ import annotations

import dataclasses

import torch

from ..codecs.device import level_cut_device, to_device, tree_occupancy_mip8
from ..codecs.kdtree import KdTree
from ..codecs.midrange import MidRangeTree
from ..ops.cuda.isosurface_kernel import IsosurfacePlan, render_isosurface_kernel
from ..ops.cuda.raycast_kernel import (CompositingPlan, block_max8, build_slab_pool,
                                       build_slab_pool_narrow, render_compositing_kernel)
from ..ops.isosurface import render_isosurface
from ..ops.raycast import MAX_SAMPLES, render_compositing
from ..ops.sampling import as_normalized_volume

__all__ = ["CompressedRenderer", "DenseRenderer"]

_POOL_BUILDERS = {"pair16": build_slab_pool, "narrowf32": build_slab_pool_narrow}


def _render(vol, rays, mode, fast, **kwargs):
    if mode == "compositing":
        render = render_compositing_kernel if fast else render_compositing
    elif mode == "isosurface":
        render = render_isosurface_kernel if fast else render_isosurface
    else:
        raise ValueError(f"unknown mode {mode}")
    return render(vol, rays.entry_uv, rays.direction, rays.hit, **kwargs)


class DenseRenderer:
    """The render API over an uncompressed (Z, Y, X) volume (uint8, or
    float in [0, 1]; a numpy array or a tensor), held on ``device``."""

    def __init__(self, volume, device: torch.device | str = "cuda"):
        self._vol = as_normalized_volume(volume, device=device)

    def volume_at(self, cut_depth=None) -> torch.Tensor:
        return self._vol

    def render(self, rays, cut_depth=None, mode: str = "compositing", **kwargs):
        """``render_compositing`` / ``render_isosurface`` of the volume."""
        return _render(self._vol, rays, mode, False, **kwargs)


class CompressedRenderer:
    """Render directly from a compressed :class:`~..codecs.kdtree.KdTree`,
    or a :class:`~..codecs.midrange.MidRangeTree`, of which it renders the
    midpoint channel (as the reference's ``levelCut`` decodes it,
    ``MidRangeTree.cpp:984-1093``).

    ``device`` holds the packed tree and everything decoded from it.  A
    decoded cut (``volume_at``), its block maxima (``mip8_at``) and its slab
    pools (``slab_pool_at``) are cached per cut depth; progressive
    refinement is rendering coarser cuts first."""

    def __init__(self, tree: KdTree | MidRangeTree, device: torch.device | str = "cuda"):
        if isinstance(tree, MidRangeTree):
            tree = tree.mid
        if not isinstance(tree, KdTree):
            raise TypeError(f"expected a KdTree or a MidRangeTree, got {type(tree).__name__}")
        self.device = torch.device(device)
        self.dtree, self.spec = to_device(tree, self.device)
        self.tree = dataclasses.replace(tree, level_codes=None, chain_codes=None,
                                        leaf_recon=None, leaf_truth=None)
        self._cache: dict[int, torch.Tensor] = {}
        self._pool_cache: dict[tuple, tuple] = {}
        self._mip_cache: dict[int, torch.Tensor] = {}

    def _cut(self, cut_depth) -> int:
        return self.spec["max_depth"] if cut_depth is None else int(cut_depth)

    def _decoded(self, cut: int) -> torch.Tensor:
        """The level cut as (Z, Y, X) uint8 on the device: the device decode,
        chunked for deep trees.  No host fallback: every error propagates."""
        return level_cut_device(self.dtree, self.spec, cut)

    def volume_at(self, cut_depth: int | None = None) -> torch.Tensor:
        """The decoded cut as a float32 volume in [0, 1], cached."""
        cut = self._cut(cut_depth)
        if cut not in self._cache:
            self._cache[cut] = as_normalized_volume(self._decoded(cut))
        return self._cache[cut]

    def mip8_at(self, cut_depth: int | None = None) -> torch.Tensor:
        """Per-8³-block maxima of the cut (``tree_occupancy_mip8``), cached;
        from the cached dense cut where there is one."""
        cut = self._cut(cut_depth)
        if cut not in self._mip_cache:
            self._mip_cache[cut] = (block_max8(self._cache[cut]) if cut in self._cache
                                    else tree_occupancy_mip8(self.dtree, self.spec, cut))
        return self._mip_cache[cut]

    def slab_pool_at(self, cut_depth: int | None = None, fmt: str = "pair16"):
        """(pool, slab_map) of the cut: only the z-slabs the tree's block
        maxima call occupied stay resident, deduplicated by content.  The
        dense decode (the cached dense cut, if any) is transient and is not
        kept; the cut's block maxima come from it when ``mip8_at`` has none
        yet, and are kept.  ``fmt``: "pair16"
        (``build_slab_pool``, 2 B per pooled voxel) or "narrowf32"
        (``build_slab_pool_narrow``, 4 B per pooled voxel)."""
        if fmt not in _POOL_BUILDERS:
            raise ValueError(f"unknown pool format {fmt!r}; expected one of "
                             f"{tuple(_POOL_BUILDERS)}")
        cut = self._cut(cut_depth)
        key = (cut, fmt)
        if key not in self._pool_cache:
            vol = self._cache[cut] if cut in self._cache else self._decoded(cut)
            if cut not in self._mip_cache:
                self._mip_cache[cut] = block_max8(vol)
            self._pool_cache[key] = _POOL_BUILDERS[fmt](vol, mip8=self._mip_cache[cut])
        return self._pool_cache[key]

    def render(self, rays, cut_depth: int | None = None, mode: str = "compositing",
               fast: bool = False, **kwargs):
        """Render the dense cut: the plain renders, or with ``fast=True``
        the kernels' entry points (B1, B2 and B3 on a CUDA device)."""
        return _render(self.volume_at(cut_depth), rays, mode, fast, **kwargs)

    def diff_decoder(self, cut_depth: int | None = None):
        """Differentiable view of this tree (``codecs/diff.py::DiffDecoder``)
        on its device: ``dec(dm, leaf_adjust)`` -> (Z, Y, X) float32 volume
        in [0, 1], its backward routing an image loss's gradient to the
        per-depth Δ map and the per-leaf scalars."""
        from ..codecs.diff import DiffDecoder

        return DiffDecoder(self.dtree, self.spec, cut_depth=cut_depth)

    def make_plan(self, rays, cut_depth: int | None = None, mode: str = "compositing",
                  skip_empty: bool = True, iso_value: float = 40.0 / 255.0,
                  max_samples: int = MAX_SAMPLES, pooled: bool = False):
        """Plan once, render many over this tree's cut: returns a
        zero-argument callable giving (rgb, alpha) for compositing or (rgb,
        found) for the isosurface.

        ``pooled=True`` is the compressed-domain render: the resident state
        is the packed tree and the slab pool, and no dense volume is kept.
        Compositing marches the pair16 pool (B7), the isosurface the narrow
        f32 pool (B8, then the pooled shade), as the JAX package's grouped
        plans choose.  Outputs equal the dense plan's bit for bit.
        ``pooled=False`` renders the cached dense cut through B1 (B2 and B3).

        ``skip_empty`` binds once, here, so every render skips exactly
        (the outputs are the same): compositing from the tree's block
        maxima (``mip8_at``, no pass over the data; a cut with no empty
        block renders unbound, there being nothing to skip), the isosurface at
        ``iso_value`` from the data it renders (``bind(pool=...)`` or
        ``bind(volume)``: min/max gates, which skip blocks on either side of
        the isovalue)."""
        X, Y, Z = self.spec["dims"]
        cut = self._cut(cut_depth)
        if mode == "compositing":
            plan = CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z),
                                   max_samples)
            if pooled:
                pool, smap = self.slab_pool_at(cut, "pair16")
                bound = plan.bind(pool=(pool, smap), mip8=self.mip8_at(cut)) if skip_empty \
                    else None
            else:
                vol = self.volume_at(cut)
                bound = plan.bind(vol, mip8=self.mip8_at(cut)) if skip_empty else None
            # a cut with data in every block has nothing to skip: its frames
            # render as the unbound plan's, with no bound to check
            if bound is not None and not bound.has_empty:
                bound = None
            if pooled:
                return lambda: plan.render_pooled(pool, smap, bound=bound)
            return lambda: plan.render(vol, bound=bound)
        if mode == "isosurface":
            plan = IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z),
                                  max_samples)
            if pooled:
                pool, smap = self.slab_pool_at(cut, "narrowf32")
                bound = plan.bind(iso_value=iso_value, pool=(pool, smap)) if skip_empty else None
                return lambda: plan.render_pooled(pool, smap, iso_value, bound=bound)
            vol = self.volume_at(cut)
            bound = plan.bind(vol, iso_value) if skip_empty else None
            return lambda: plan.render(vol, iso_value, bound=bound)
        raise ValueError(f"unknown mode {mode}")
