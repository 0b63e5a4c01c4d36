"""Work of the compositing march (B1): the bytes it has to move and the
float32 operations it has to do, from the shapes and the samples per ray
that the benchmark's plain reference counts on the same inputs.

Conventions (PERF.md, section 6): each input read once and each output
written once; of the volume only the voxels the taps read; per step 50
operations (a trilinear sample 41, a position step 3, compositing 6), 8 x 4
more on a float32 volume whose taps are quantized as they are read, and one
per ray for the transfer.
"""
RAY_BYTES = 25       # entry_uv and dir_step (float32 x 3 each), hit (1 byte)
RGBA_BYTES = 16      # rgb (float32 x 3) and alpha written
OPS_PER_STEP = 50
QUANTIZE_OPS_PER_TAP = 4
TRANSFER_OPS_PER_RAY = 1


def march(rays: float, samples: float, voxels_read: float, voxel_bytes: int):
    """(bytes, ops) of one launch over ``rays`` rays taking ``samples``
    samples in all, whose taps read ``voxels_read`` distinct voxels of
    ``voxel_bytes`` each (4: float32, quantized per tap; 1: bytes)."""
    per_step = OPS_PER_STEP + (8 * QUANTIZE_OPS_PER_TAP if voxel_bytes == 4 else 0)
    return (voxel_bytes * voxels_read + (RAY_BYTES + RGBA_BYTES) * rays,
            per_step * samples + TRANSFER_OPS_PER_RAY * rays)
