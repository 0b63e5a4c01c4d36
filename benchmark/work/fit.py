"""Work of one step of the multi-view fit: the TF march (B4) forward, the
voxel-gradient march (B5) backward, and the whole step's least work.

Conventions (PERF.md, section 6): each input read once and each output
written once.  B4 reads the float32 voxels its taps read, quantizing each of
the 8 taps as it reads them (66 + 8 x 4 operations a step), the TF scalars
(12 B) and the rays (25 B), and writes seven float32 planes per ray.  B5
replays every step (94 operations: the step, its cotangent, the tap weights
and 8 atomic adds), reading the byte volume, the TF scalars, three
cotangent planes (12 B a ray) and the rays, and writing the float32
gradient of every voxel.  The whole step at the least reads the volume, the
rays and the targets (12 B a ray) and writes the volume, and does B4's and
B5's operations.
"""
RAY_BYTES = 25
TF_OPS_PER_STEP = 66 + 8 * 4
VG_OPS_PER_STEP = 94
TF_SCALAR_BYTES = 12


def forward(rays: float, samples: float, voxels_read: float):
    return 4 * voxels_read + TF_SCALAR_BYTES + rays * (RAY_BYTES + 7 * 4), TF_OPS_PER_STEP * samples


def backward(rays: float, samples: float, voxels: float):
    return (voxels + TF_SCALAR_BYTES + rays * (12 + RAY_BYTES) + 4 * voxels,
            VG_OPS_PER_STEP * samples)


def step(rays: float, samples: float, voxels: float):
    return 8 * voxels + rays * (RAY_BYTES + 12), (TF_OPS_PER_STEP + VG_OPS_PER_STEP) * samples
