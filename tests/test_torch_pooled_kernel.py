"""The pooled CUDA kernels (B6–B9 and the pooled shade) and the compiled
kd-tree seed helper, on the card.

Each pooled kernel must equal its dense counterpart (B1, B2, B3) bit for bit
on the volume the pool was built from, and its plain version (the
sampler-generic plain march with ``slab_pool_sampler``) within the bars of
the dense kernels' tests.  The compiled seed helper must give the Python
loop's (sum, count) bit for bit.  Without a CUDA device every test skips; the
CPU side of the same code is tests/test_torch_pooled.py.

This file imports no JAX, so it runs on the card's machine alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_pooled_kernel.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.isosurface import iso_march_steps, shade_hits
from volumerenderer_tpu_torch.ops.raycast import composite_march_steps, step_sizes
from volumerenderer_tpu_torch.ops.sampling import slab_pool_sampler

POOLS = {"pair16": RK.build_slab_pool, "narrow": RK.build_slab_pool_narrow}
MARCHES = {"pair16": (RK.composite_march_pooled_pair16_cuda, IK.iso_march_pooled_pair16_cuda),
           "narrow": (RK.composite_march_pooled_narrow_cuda, IK.iso_march_pooled_narrow_cuda)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_scene(device, volume):
    if volume == "turbulence":
        u8 = turbulence_volume((64, 48, 96), seed=1)
        u8[:16] = 0  # two empty z-blocks: slot-0 reads
    else:
        u8 = sphere_volume((64, 48, 96))
    vol_u8 = torch.from_numpy(u8).to(device)
    # a grazing camera whose rays enter through the x = 0 face
    rays = generate_rays(Camera(width=96, height=64, position=(-0.62, 0.1, -0.45),
                                front=(0.62, -0.1, 0.45)), device=device)
    Z, Y, X = vol_u8.shape
    dir_step = (rays.direction * step_sizes((X, Y, Z), device)).contiguous()
    return vol_u8, rays, dir_step, rays.hit.to(torch.uint8)


def _within_bars(k, p):
    # a 1-ulp difference at the 0.99 early-out costs one composite step
    d = (k - p).abs()
    return float(d.max()) <= 1.5e-2 and int((d > 1e-5).sum()) <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("volume", ["turbulence", "sphere"])
@pytest.mark.parametrize("fmt", sorted(POOLS))
def test_pooled_compositing_kernel_on_cuda(cuda_device, fmt, volume):
    vol_u8, rays, dir_step, hit = _card_scene(cuda_device, volume)
    pool, smap = POOLS[fmt](vol_u8)
    march = MARCHES[fmt][0]
    before = march.launches
    c_k, a_k = march(pool, smap, rays.entry_uv, dir_step, hit)
    torch.cuda.synchronize()
    assert march.launches == before + 1
    c_d, a_d = RK.composite_march_cuda(vol_u8, rays.entry_uv, dir_step, hit)
    assert float(a_d.max()) > 0.5
    assert torch.equal(c_k, c_d) and torch.equal(a_k, a_d)
    c_p, a_p = composite_march_steps(slab_pool_sampler(pool, smap, (96, 48, 64)),
                                     rays.entry_uv, dir_step, rays.hit)
    assert _within_bars(c_k, c_p) and _within_bars(a_k, a_p)


@pytest.mark.cuda
@pytest.mark.parametrize("volume", ["turbulence", "sphere"])
@pytest.mark.parametrize("fmt", sorted(POOLS))
def test_pooled_isosurface_kernels_on_cuda(cuda_device, fmt, volume):
    vol_u8, rays, dir_step, hit = _card_scene(cuda_device, volume)
    iso = IK.volume_median(as_normalized_volume(vol_u8)) if volume == "turbulence" else 0.5
    pool, smap = POOLS[fmt](vol_u8)
    march = MARCHES[fmt][1]
    before = (march.launches, IK.iso_shade_pooled_cuda.launches)
    found_k, t_hit_k = march(pool, smap, rays.entry_uv, dir_step, hit, iso)
    rgb_k = IK.iso_shade_pooled_cuda(pool, smap, rays.entry_uv, dir_step, rays.direction,
                                     found_k, t_hit_k, iso)
    torch.cuda.synchronize()
    assert (march.launches, IK.iso_shade_pooled_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    found_d, t_hit_d = IK.iso_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, iso)
    rgb_d = IK.iso_shade_cuda(vol_u8, rays.entry_uv, dir_step, rays.direction, found_k,
                              t_hit_k, iso)
    assert int(found_d.sum()) > 100
    assert torch.equal(found_k, found_d) and torch.equal(t_hit_k, t_hit_d)
    assert torch.equal(rgb_k, rgb_d)
    sampler = slab_pool_sampler(pool, smap, (96, 48, 64))
    found_p, t_hit_p = iso_march_steps(sampler, rays.entry_uv, dir_step, rays.hit, iso)
    rgb_p = shade_hits(sampler, rays.entry_uv, dir_step, rays.direction, found_k, t_hit_k, iso)
    assert int(((found_k != found_p) | (t_hit_k != t_hit_p)).sum()) <= 4
    assert float((rgb_k - rgb_p).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_compiled_seed_helper_matches_python_loop(cuda_device):
    rng = np.random.default_rng(11)
    n = 1 << 20
    truth = rng.integers(0, 256, n, dtype=np.uint8)
    parent = np.clip(truth.astype(np.int32) + rng.integers(-60, 61, n), 0, 255).astype(np.int32)
    got = TK._seed_level_native(truth, parent)
    assert got == TK._seed_level_py(truth, parent)
    assert got[1] > 0


@pytest.mark.cuda
def test_pooled_wrappers_reject_mixed_devices_on_cuda(cuda_device):
    vol_u8, rays, dir_step, hit = _card_scene(cuda_device, "sphere")
    pool, smap = RK.build_slab_pool(vol_u8)
    with pytest.raises(ValueError, match="is on cpu"):
        RK.composite_march_pooled_pair16_cuda(pool, smap.cpu(), rays.entry_uv, dir_step, hit)
