"""volumerenderer_tpu_torch — the volume renderer ported to PyTorch and CUDA.

The package beside ``volumerenderer_tpu`` (JAX), which stays the reference it
is held against.  Plain PyTorch carries ray generation, sampling and the
reference compositing and isosurface renders; the compositing march and the
isosurface march and shade also run as hand-written CUDA kernels for Hopper
(``ops/cuda``, ``csrc/``), built with ``nvcc`` at first use.
It imports neither jax nor ``volumerenderer_tpu``.
"""

from .camera import Camera, RayBundle, generate_rays
from .ops.sampling import sample_trilinear, as_normalized_volume
from .ops.raycast import composite_march, render_compositing
from .ops.isosurface import render_isosurface

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "RayBundle",
    "generate_rays",
    "sample_trilinear",
    "as_normalized_volume",
    "composite_march",
    "render_compositing",
    "render_isosurface",
]
