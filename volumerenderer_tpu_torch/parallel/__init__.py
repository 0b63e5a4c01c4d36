"""Multi-device rendering and fitting over a mesh of devices (counterpart of
``volumerenderer_tpu/parallel``): image rows sharded over a mesh
(``sharding``, and ``kernel_sharded`` on the CUDA kernels), and the volume
sharded in z slabs (``context``) or bricks (``bricks``), marched inside each
shard by the segment kernels (``kernel_sharded``).  Entry points default to
the host's CUDA cards; a CPU mesh is asked for by passing its devices."""

from .bricks import (ShardedVolume, host_local_bricks_3d, make_brick_mesh, render_bricksharded,
                     shard_volume)
from .context import composite_segments, make_z_mesh, render_zsharded
from .kernel_sharded import (render_bricksharded_kernel, render_planned_sharded,
                             render_zsharded_kernel, scaling_probe_kernel,
                             tf_fit_step_bricksharded, tf_fit_step_kernel, voxel_fit_step_kernel)
from .multihost import (gather, global_mesh, host_local_bricks, initialize, load_bricks_for_host,
                        measure_scaling_efficiency, process_count, process_index)
from .sharding import (DeviceMesh, make_mesh, render_tf_sharded, scaling_efficiency_probe,
                       tf_fit_step)

__all__ = ["DeviceMesh", "make_mesh", "render_tf_sharded", "tf_fit_step", "make_z_mesh",
           "render_zsharded", "composite_segments", "make_brick_mesh", "ShardedVolume",
           "shard_volume", "render_bricksharded", "render_planned_sharded",
           "tf_fit_step_kernel", "voxel_fit_step_kernel", "render_zsharded_kernel",
           "render_bricksharded_kernel", "tf_fit_step_bricksharded", "scaling_efficiency_probe",
           "scaling_probe_kernel", "host_local_bricks_3d", "initialize", "process_index",
           "process_count", "global_mesh", "gather", "host_local_bricks", "load_bricks_for_host",
           "measure_scaling_efficiency"]
