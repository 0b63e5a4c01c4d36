"""Renderer registry (PyTorch counterpart of
``volumerenderer_tpu/models/__init__.py``).

``reference_renderer()`` returns the plain PyTorch renderer with the
reference arithmetic; ``best_renderer()`` returns a renderer that runs the
CUDA march kernel for inputs on a CUDA device and the plain renderer for CPU
inputs; ``plan_compositing`` builds the plan-once / render-many API.
``best_isosurface_renderer()`` does the same for the isosurface render, with
the CUDA march and shade kernels.  ``CompressedRenderer`` renders straight
from a compressed kd-tree (``compressed.py``); ``DenseRenderer`` is its API
over a plain volume.
"""
from __future__ import annotations

from ..ops.cuda.isosurface_kernel import render_isosurface_kernel
from ..ops.cuda.raycast_kernel import CompositingPlan, render_compositing_kernel
from ..ops.isosurface import render_isosurface
from ..ops.raycast import MAX_SAMPLES, render_compositing
from .compressed import CompressedRenderer, DenseRenderer

__all__ = ["reference_renderer", "best_renderer", "plan_compositing",
           "best_isosurface_renderer", "CompressedRenderer", "DenseRenderer"]


def reference_renderer():
    return render_compositing


def _render_best(volume, entry_uv, direction, hit, max_samples: int = MAX_SAMPLES,
                 wrap: str = "clamp"):
    if volume.is_cuda:
        return render_compositing_kernel(volume, entry_uv, direction, hit, max_samples, wrap)
    return render_compositing(volume, entry_uv, direction, hit, max_samples, wrap)


def best_renderer():
    """Same signature as ``render_compositing``; picks the kernel by where
    the volume lies."""
    return _render_best


def plan_compositing(entry_uv, direction, hit, dims, max_samples: int = MAX_SAMPLES):
    """Plan-once / render-many: the kernel for rays on a CUDA device, the
    plain march for rays on the CPU (same API either way)."""
    return CompositingPlan(entry_uv, direction, hit, dims, max_samples)


def _render_iso_best(volume, entry_uv, direction, hit, iso_value=40.0 / 255.0,
                     max_samples: int = MAX_SAMPLES, wrap: str = "clamp"):
    if volume.is_cuda:
        return render_isosurface_kernel(volume, entry_uv, direction, hit, iso_value,
                                        max_samples, wrap)
    return render_isosurface(volume, entry_uv, direction, hit, iso_value, max_samples, wrap)


def best_isosurface_renderer():
    """Same signature as ``ops.isosurface.render_isosurface``; the march and
    shade kernels for a volume on a CUDA device, the plain path for a volume
    on the CPU."""
    return _render_iso_best
