"""Work of an isosurface frame: the bind (the block grid of the volume), the
bound march (B2) and the shade (B3), from the shapes and the counts that
the benchmark's plain reference makes on the same inputs.

Conventions (PERF.md, section 6): each input read once and each output
written once.  The bound march reads the rays (25 B each) and the grid,
writes found (1 B) and t_hit (4 B) for every ray and the near bracket (12 B)
for each hit; a step classifies its sample's block (9 operations) and
gathers only in a block that straddles the isovalue: a gathered sample 49 +
9 operations, a skipped one 49 - 41 + 9.  The shade reads found and writes
rgb (12 B) for every ray, reads near, dir_step and direction (36 B) for each
hit and the voxels its taps read, and does 515 operations a hit (the far end
of the bracket 3, 4 bisections 47 each, 6 normal taps 44 each, Phong 60).
The bind reads the volume once and writes the grid.
"""
RAY_BYTES = 25
OPS_PER_STEP = 49
TRILINEAR_OPS = 41
CLASSIFY_OPS = 9
GATHERED_OPS = OPS_PER_STEP + CLASSIFY_OPS
SKIPPED_OPS = OPS_PER_STEP - TRILINEAR_OPS + CLASSIFY_OPS
SHADE_OPS_PER_HIT = 3 + 4 * 47 + 6 * 44 + 60


def bind(volume_bytes: float, grid_bytes: float):
    """(bytes, ops) of binding a volume: it is read once, the grid written."""
    return volume_bytes + grid_bytes, 0.0


def march(rays: float, hits: float, samples: float, gathered: float, voxel_bytes_read: float,
          grid_bytes: float):
    """(bytes, ops) of one bound march: ``samples`` taken in all (a hit's
    steps and its lookahead, a miss's steps inside the cube and one more),
    ``gathered`` of them in mixed blocks, whose taps read
    ``voxel_bytes_read`` bytes of the volume."""
    n_bytes = voxel_bytes_read + rays * (RAY_BYTES + 1 + 4) + 12 * hits + grid_bytes
    return n_bytes, GATHERED_OPS * gathered + SKIPPED_OPS * (samples - gathered)


def shade(rays: float, hits: float, voxel_bytes_read: float):
    """(bytes, ops) of one shade launch."""
    return voxel_bytes_read + 36 * hits + 13 * rays, SHADE_OPS_PER_HIT * hits
