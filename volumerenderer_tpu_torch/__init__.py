"""volumerenderer_tpu_torch — the volume renderer ported to PyTorch and CUDA.

The package beside ``volumerenderer_tpu`` (JAX), which stays the reference it
is held against.  Plain PyTorch carries ray generation, sampling and the
reference compositing and isosurface renders and the differentiable TF render
(``diff``); the compositing march, the isosurface march and shade, and the
TF-gradient and voxel-gradient marches also run as hand-written CUDA kernels
for Hopper (``ops/cuda``, ``csrc/``), built with ``nvcc`` at first use.
The compressed domain (``codecs``: the kd-tree built on the host or with its
passes on the device, decoded on the device; the mid-range, Morton-hashed
and octree codecs) renders through ``CompressedRenderer`` from sparse slab
pools, with pooled variants of the same kernels; ``io.bricks`` assembles
bricked volumes.  ``parallel`` shards the image
rows, or the volume in z slabs or bricks, over a mesh of devices, which may
span several processes (``parallel.multihost`` on ``torch.distributed``:
``initialize``, ``global_mesh``, per-host brick I/O); inside a volume shard
the segment marches run, and ``entry.dryrun_multichip`` runs every layout
once at small shapes.  The application layer: ``config``
(the ``AppConfig`` dataclass tree), ``app`` (the reference ``main()`` flow,
``app.run``, and the camera-state machine), ``io.streaming`` (the
multi-timestep ``TimestepStreamer``), the kd-tree and mid-range checkpoint
files (``codecs.kdtree.save`` / ``open_tree_full``, byte for byte the JAX
package's), ``codecs.reference_impl`` (the sequential codec for any
dimensions, natively in ``csrc/kdtree_native.cu``) and ``utils.timer``
(``DebugTimer``, ``timed`` with a ``torch.profiler`` trace, ``Metrics``,
and ``span``, the ``vr.*`` ranges a profiler sees where each layer's work
happens).  It imports neither jax nor ``volumerenderer_tpu``.
"""

from .camera import Camera, RayBundle, generate_rays
from .ops.sampling import sample_trilinear, as_normalized_volume
from .ops.raycast import composite_march, render_compositing
from .ops.isosurface import render_isosurface
from .diff.transfer import TFParams, render_tf
from .codecs.kdtree import KdTree
from .models.compressed import CompressedRenderer
from .config import AppConfig, CodecConfig, DatasetConfig, DistributedConfig, RenderConfig
from .parallel import (DeviceMesh, global_mesh, make_brick_mesh, make_mesh, make_z_mesh,
                       render_bricksharded_kernel, render_zsharded_kernel, shard_volume)
from .entry import dryrun_multichip

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
    "TFParams",
    "render_tf",
    "KdTree",
    "CompressedRenderer",
    "AppConfig",
    "CodecConfig",
    "DatasetConfig",
    "DistributedConfig",
    "RenderConfig",
    "DeviceMesh",
    "make_mesh",
    "make_z_mesh",
    "make_brick_mesh",
    "shard_volume",
    "render_zsharded_kernel",
    "render_bricksharded_kernel",
    "global_mesh",
    "dryrun_multichip",
]
