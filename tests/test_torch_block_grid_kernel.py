"""The iso bind's block grid kernel (``csrc/block_grid.cu``, wrapper
``ops/cuda/blockgrid_kernel.py::iso_block_grid_cuda``) against its plain
version, ``ops/blockgrid.py::iso_block_grid``.

On the CPU: a bind of CPU data takes the plain version and never the
kernel, and the wrapper refuses what the plain version refuses, and a CPU
tensor.  The ``cuda``-marked tests hold the kernel's grid to the plain one
bit for bit on the card: bytes and float32 (ties at (k + 0.5)/255, values
below 0 and above 1), clamp and repeat, ragged shapes, views, and volumes
past 2^31 bytes, one of them of a ragged depth whose threads walk several
z-blocks; and a bind of each plan launches it once.  This file imports no
JAX:
``python3 -m pytest --noconftest -m cuda tests/test_torch_block_grid_kernel.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.ops.blockgrid import iso_block_grid
from volumerenderer_tpu_torch.ops.cuda import blockgrid_kernel as GK
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK

PLANS = {"iso": IK.IsosurfacePlan, "composite": RK.CompositingPlan}


def _ramp(shape, seed: int) -> np.ndarray:
    """Bytes that rise along every axis, plus noise: a block's least and
    largest byte sit at opposite corners of its footprint, so a texel left
    out of it (the apron at 8b + 8) changes the cell."""
    z, y, x = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    noise = np.random.default_rng(seed).integers(0, 3, shape)
    return ((2 * x + 3 * y + 5 * z + noise) % 256).astype(np.uint8)


def _floats(vol_u8: np.ndarray, seed: int) -> np.ndarray:
    """float32 values around the bytes: exact ties (k + 0.5)/255, the next
    float above a tie, k/255, and a stretch of the range that leaves [0, 1]."""
    k = vol_u8.astype(np.float64)
    tie = ((k + 0.5) / 255.0).astype(np.float32)
    kinds = [tie, np.nextafter(tie, np.float32(2.0)), (k / 255.0).astype(np.float32),
             ((k - 12.0) / 230.0).astype(np.float32)]
    pick = np.random.default_rng(seed).integers(0, len(kinds), vol_u8.shape)
    return np.choose(pick, kinds).astype(np.float32)


def _scene(kind: str, vol, wrap: str = "clamp"):
    Z, Y, X = vol.shape
    rays = generate_rays(Camera(width=16, height=12), device=vol.device)
    return PLANS[kind](rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), wrap=wrap)


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("kind", list(PLANS))
def test_cpu_bind_takes_the_plain_grid(kind, wrap):
    vol = as_normalized_volume(turbulence_volume((12, 17, 20), seed=4), device="cpu")
    before = GK.iso_block_grid_cuda.launches
    bound = _scene(kind, vol, wrap).bind(vol) if kind == "composite" else \
        _scene(kind, vol, wrap).bind(vol, 0.5)
    assert GK.iso_block_grid_cuda.launches == before
    assert torch.equal(bound.grid, iso_block_grid(vol, wrap))


@pytest.mark.parametrize("volume,wrap,match", [
    ("u8", "mirror", "unknown wrap mode"),
    ("flat", "clamp", "non-empty"),
    ("empty", "clamp", "non-empty"),
    ("u8", "clamp", "CUDA volume"),
])
def test_wrapper_refuses_as_the_plain_version_does(volume, wrap, match):
    """A bad wrap or shape raises the plain version's error; a CPU tensor,
    which the plain version takes, raises too."""
    vol = {"u8": torch.zeros(4, 5, 6, dtype=torch.uint8), "flat": torch.zeros(4, 5),
           "empty": torch.zeros(0, 5, 6)}[volume]
    with pytest.raises(ValueError, match=match) as got:
        GK.iso_block_grid_cuda(vol, wrap)
    if match != "CUDA volume":
        with pytest.raises(ValueError) as plain:
            iso_block_grid(vol, wrap)
        assert str(got.value) == str(plain.value)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(name: str, device):
    """The volume of case ``name`` on ``device``."""
    shape = {"dims_1_7_9": (1, 7, 9), "dims_9_17_1": (9, 17, 1), "dims_17_1_7": (17, 1, 7),
             "dims_7_9_17": (7, 9, 17), "x_33": (20, 27, 33), "x_100": (24, 40, 100),
             "x_256": (40, 33, 256), "x_528": (16, 24, 528), "x_2064": (13, 21, 2064)}
    dtype, _, rest = name.partition("_")
    if rest in shape:
        vol_u8 = _ramp(shape[rest], seed=len(name))
        vol = vol_u8 if dtype == "u8" else _floats(vol_u8, seed=len(name))
        return torch.from_numpy(vol).to(device)
    base = _ramp((19, 30, 300), seed=7)
    if dtype != "u8":
        base = _floats(base, seed=3).astype(dtype)
    base = torch.from_numpy(base).to(device)
    if rest == "offset_view":  # rows and the base off 16-byte alignment
        return base[2:, 1:-3, 3:]
    if rest == "transposed":  # x not contiguous: copied first
        return base.transpose(1, 2)
    if rest == "broadcast":  # zero strides
        return base[:1, :1].expand(19, 30, 300)
    raise KeyError(name)


CASES = ([f"u8_{s}" for s in ("dims_1_7_9", "dims_9_17_1", "dims_17_1_7", "dims_7_9_17",
                              "x_33", "x_100", "x_256", "x_528", "x_2064", "offset_view",
                              "transposed", "broadcast")]
         + [f"f32_{s}" for s in ("dims_1_7_9", "dims_7_9_17", "x_33", "x_100", "x_528")]
         + ["float64_offset_view", "float16_transposed"])


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_grid_equals_plain_on_cuda(cuda_device, case, wrap):
    vol = _case(case, cuda_device)
    before = GK.iso_block_grid_cuda.launches
    got = GK.iso_block_grid_cuda(vol, wrap)
    torch.cuda.synchronize()
    assert GK.iso_block_grid_cuda.launches == before + 1
    want = iso_block_grid(vol, wrap)
    assert got.shape == want.shape and got.dtype == torch.uint8 and got.is_contiguous()
    assert torch.equal(got, want)


def _walking_depth(device) -> int:
    """A ragged Z (8k + 3) at which every thread of a 2048x2048 x-y plane
    walks at least 2 z-blocks, carrying plane 8b + 8 into block b + 1.
    ``launch()`` in ``csrc/block_grid.cu`` gives a thread floor(tiles * nbz
    / (kWaves * resident)) z-blocks (kWaves 4, 128 threads a block; here
    tiles = 2048 / 8, one row of 128 threads a y-block), so this takes the
    most blocks of 128 threads the card could hold resident."""
    props = torch.cuda.get_device_properties(device)
    resident = props.multi_processor_count * (
        getattr(props, "max_threads_per_multi_processor", 2048) // 128)
    tiles = 2048 // 8
    return 8 * -(-2 * 4 * resident // tiles) + 3


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("depth", ["z520", "ragged_walk"])
def test_kernel_grid_past_2_31_bytes(cuda_device, wrap, depth):
    """A 2048x2048x520 byte volume (2.18e9 bytes): offsets past 2^31; and
    one of a ragged depth (2048x2048x531 on an H100, 2.23e9 bytes) whose
    threads walk several z-blocks each, so the carried plane and the
    clamped or wrapped last planes meet.  The small cases above walk one
    z-block a thread."""
    Z, Y, X = (520 if depth == "z520" else _walking_depth(cuda_device)), 2048, 2048
    assert Z == 520 or Z % 8 == 3
    dev = cuda_device

    def axis(n, k):
        return (torch.arange(n, device=dev) * k % 256).to(torch.uint8)

    vol = axis(Z, 5)[:, None, None] + axis(Y, 3)[None, :, None] + axis(X, 2)
    vol[-1, -1, -9:] = torch.arange(9, dtype=torch.uint8, device=dev) * 29
    assert vol.numel() > 2**31
    got = GK.iso_block_grid_cuda(vol, wrap)
    want = iso_block_grid(vol, wrap)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(PLANS))
def test_plan_bind_launches_the_kernel_once(cuda_device, kind):
    vol_u8 = torch.from_numpy(_ramp((24, 40, 72), seed=5)).to(cuda_device)
    plan = _scene(kind, vol_u8)
    before = GK.iso_block_grid_cuda.launches
    bound = plan.bind(vol_u8) if kind == "composite" else plan.bind(vol_u8, 0.5)
    torch.cuda.synchronize()
    assert GK.iso_block_grid_cuda.launches == before + 1
    assert torch.equal(bound.grid, iso_block_grid(vol_u8))
