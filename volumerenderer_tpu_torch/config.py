"""Unified configuration: the reference's edit-the-source knobs as one
dataclass tree.

Counterpart of ``volumerenderer_tpu/config.py``, field for field and default
for default, on the port's ``Camera`` and ``io.bricks`` constants.
``RenderConfig.use_pallas_kernel`` keeps its name and is the kernel switch:
``app.run`` renders through the hand-written CUDA kernels (the compressed
renderer's pooled plan) when it is set, through the plain PyTorch render
otherwise.

Every configurable surface of the reference is represented, with reference
defaults and source citations:

* window 1600x1200 (``main.cpp:27``), vertical fov 50 (``:40``), camera start
  (0, 0, -0.75)/(0, 0, 1)/(0, 1, 0) (``:33-35``);
* shader choice by file swap (``:71-75``) -> ``render_mode``;
* MAX_SAMPLES = 300 (``raycaster.frag:14``), isovalue 40/255 stepped by 5/255
  (``main.cpp:52,489-498``), DELTA = 0.01, specular 250, diffuse
  (0.39, 0.58, 0.93) (``isosurface.frag:18,155``);
* codec knobs tolerance/maxEpochs (defaults 6/5, ``VolumeKdtree_recover.h:
  110-112``; the main() run uses 1/2, ``main.cpp:253-254``), GD constants
  gamma 1.25 / h 1.0 / max step 4 (``VolumeKdTree_recover.cpp:209-211``), the
  extra-level ladder 64..1 (``:23``);
* dataset: brick 256x256x128, grid 8x8x15, timestep 273, 384 bricks as 8x8x6
  (``main.cpp:78-79,242``), path template ``bob<ttt>/d_<tttt>_<bbbb>``
  (``:580-597``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from .camera import Camera
from .io.bricks import RM_BRICK_DIMS, RM_VOLUME_GRID

__all__ = ["RenderConfig", "CodecConfig", "DatasetConfig", "DistributedConfig",
           "AppConfig"]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    camera: Camera = Camera()
    render_mode: Literal["compositing", "isosurface"] = "compositing"
    max_samples: int = 300
    iso_value: float = 40.0 / 255.0
    iso_step: float = 5.0 / 255.0
    wrap: Literal["clamp", "repeat"] = "clamp"
    use_pallas_kernel: bool = True       # the CUDA kernels (app.run's plan)
    early_exit: bool = True              # a > 0.99 break (raycaster.frag:77)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    codec: Literal["kdtree", "midrange", "hashed", "octree"] = "kdtree"
    tolerance: int = 6
    max_epochs: int = 5
    cut_depth: int | None = None         # None = maxTreeDepth (main.cpp:281)


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    source: Literal["rm_bricks", "synthetic"] = "synthetic"
    top_dir: str = ""
    brick_dims: tuple[int, int, int] = RM_BRICK_DIMS
    volume_grid: tuple[int, int, int] = RM_VOLUME_GRID
    num_bricks: int = 384
    load_grid: tuple[int, int, int] = (8, 8, 6)
    timestep: int = 273
    synthetic_kind: str = "turbulence"
    synthetic_dims: tuple[int, int, int] = (256, 256, 256)


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    dp: int = 1                  # view-batch data parallelism
    ray_shards: int = 1          # image-row sharding
    z_shards: int = 1            # context-parallel volume sharding
    prefetch_timesteps: int = 1  # streaming pipeline depth


@dataclasses.dataclass(frozen=True)
class AppConfig:
    render: RenderConfig = RenderConfig()
    codec: CodecConfig = CodecConfig()
    dataset: DatasetConfig = DatasetConfig()
    distributed: DistributedConfig = DistributedConfig()
    tree_path: str = "tree_384_1tolerance.bin"   # main.cpp:267
