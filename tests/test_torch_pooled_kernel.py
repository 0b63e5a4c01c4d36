"""The pooled CUDA kernels (B6–B9 and the pooled shade) and the compiled
kd-tree seed helper, on the card.

Each pooled kernel must equal its dense counterpart (B1, B2, B3) bit for bit
on the volume the pool was built from, and its plain version (the
sampler-generic plain march with ``slab_pool_sampler``) within the bars of
the dense kernels' tests.  On the slab-pool sampler's edges (rays through the
low x face, across every z-block in both z directions, empty and shared
slots, an out-of-range slab map, a pool past 2^32 words) all five are held
bit-equal to both.  The compiled seed helper must give the Python
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
from volumerenderer_tpu_torch.ops.raycast import (apply_reference_transfer, composite_march_steps,
                                                  step_sizes)
from volumerenderer_tpu_torch.ops.sampling import slab_pool_sampler, texel_coords

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
    rgb_k, a_k = march(pool, smap, rays.entry_uv, dir_step, hit)
    torch.cuda.synchronize()
    assert march.launches == before + 1
    rgb_d, a_d = RK.composite_march_cuda(vol_u8, rays.entry_uv, dir_step, hit)
    assert float(a_d.max()) > 0.5
    assert torch.equal(rgb_k, rgb_d) and torch.equal(a_k, a_d)
    c_p, a_p = composite_march_steps(slab_pool_sampler(pool, smap, (96, 48, 64)),
                                     rays.entry_uv, dir_step, rays.hit)
    # r = g = 1 - c and b = 1: the r plane within the bars of the plain one
    rgb_p = apply_reference_transfer(c_p, a_p)
    assert _within_bars(rgb_k[..., 0], rgb_p[..., 0]) and _within_bars(a_k, a_p)


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


# The slab-pool sampler's edges (csrc/trilinear.cuh, PoolSampler): a (Z, Y,
# X) = (96, 48, 64) volume of 12 z-blocks, dimmed so that rays cross it whole
EDGE_DIMS = (64, 48, 96)  # (X, Y, Z)
EDGE_CAMERAS = {
    # enters through the x = 0 face: i0x < 0, x0 odd and even
    "low_x_face": dict(position=(-0.62, 0.1, -0.45), front=(0.62, -0.1, 0.45)),
    # along +z and along -z through every z-block
    "z_forward": dict(position=(0.08, 0.05, -0.75), front=(-0.08, -0.05, 0.75)),
    "z_backward": dict(position=(-0.08, 0.05, 0.75), front=(0.08, -0.05, -0.75)),
}


def _edge_volume():
    """Turbulence at a tenth of its bytes in z-blocks 0-1 and 9-11; blocks 2-4
    empty, so slabs 2 and 3 read slot 0 between occupied slots; blocks 5-8
    one block repeated, so slabs 5-7 share one slot."""
    u8 = (turbulence_volume(EDGE_DIMS[::-1], seed=2).astype(np.float32) * 0.1).astype(np.uint8)
    u8[16:40] = 0
    u8[48:72] = np.tile(u8[40:48], (3, 1, 1))
    return u8


def _edge_rays(device, camera, dims=EDGE_DIMS, width=96, height=64):
    rays = generate_rays(Camera(width=width, height=height, **EDGE_CAMERAS[camera]),
                         device=device)
    dir_step = (rays.direction * step_sizes(dims, device)).contiguous()
    return rays, dir_step, rays.hit.to(torch.uint8)


def _anchors(rays, dir_step, dims):
    """The texel anchors (N, 3) of every position inside the cube that the
    rays step through (no early-out)."""
    pos, alive, out = rays.entry_uv, rays.hit.bool(), []
    while bool(alive.any()):
        pos = pos + dir_step
        alive = alive & ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
        out.append(texel_coords(pos[alive], dims)[0])
    return torch.cat(out)


def _five(fmt, pool, smap, rays, dir_step, hit, iso):
    """B6 or B7 (the rgb of its epilogue), B8 or B9 and the pooled shade on
    one pool, each launched once."""
    comp, march = MARCHES[fmt]
    before = (comp.launches, march.launches, IK.iso_shade_pooled_cuda.launches)
    rgb_e, a_e = comp(pool, smap, rays.entry_uv, dir_step, hit)
    found, t_hit = march(pool, smap, rays.entry_uv, dir_step, hit, iso)
    rgb = IK.iso_shade_pooled_cuda(pool, smap, rays.entry_uv, dir_step, rays.direction, found,
                                   t_hit, iso)
    torch.cuda.synchronize()
    assert (comp.launches, march.launches, IK.iso_shade_pooled_cuda.launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    return {"rgb": rgb_e, "alpha": a_e, "found": found, "t_hit": t_hit, "shade": rgb}


def _dense(vol_u8, rays, dir_step, hit, iso, found, t_hit):
    """B1 (rgb), B2 and B3 on the volume, the shade fed the pooled march's
    hits."""
    rgb_e, a_e = RK.composite_march_cuda(vol_u8, rays.entry_uv, dir_step, hit)
    f, t = IK.iso_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, iso)
    rgb = IK.iso_shade_cuda(vol_u8, rays.entry_uv, dir_step, rays.direction, found, t_hit, iso)
    return {"rgb": rgb_e, "alpha": a_e, "found": f, "t_hit": t, "shade": rgb}


def _plain(pool, smap, dims, rays, dir_step, iso, found, t_hit):
    """The plain versions through ``slab_pool_sampler``."""
    sampler = slab_pool_sampler(pool, smap, dims)
    hit = rays.hit.bool()
    c, a = composite_march_steps(sampler, rays.entry_uv, dir_step, hit)
    f, t = iso_march_steps(sampler, rays.entry_uv, dir_step, hit, iso)
    rgb = shade_hits(sampler, rays.entry_uv, dir_step, rays.direction, found, t_hit, iso)
    return {"rgb": apply_reference_transfer(c, a), "alpha": a, "found": f, "t_hit": t,
            "shade": rgb}


def _assert_equal(got, want, what):
    differ = [k for k in got if not torch.equal(got[k], want[k])]
    assert not differ, f"pooled kernels differ from {what} in {differ}"


@pytest.mark.cuda
@pytest.mark.parametrize("camera", sorted(EDGE_CAMERAS))
@pytest.mark.parametrize("fmt", sorted(POOLS))
def test_pool_sampler_edges_bit_equal_on_cuda(cuda_device, fmt, camera):
    u8 = _edge_volume()
    vol_u8 = torch.from_numpy(u8).to(cuda_device)
    pool, smap = POOLS[fmt](vol_u8)
    slots = smap[0].tolist()
    # slot 0 between occupied slots, and one slot shared by three slabs
    assert slots[2] == slots[3] == 0 < slots[1] and slots[4] > 0
    assert slots[5] == slots[6] == slots[7] > 0 and len(set(slots)) < len(slots) - 2
    rays, dir_step, hit = _edge_rays(cuda_device, camera)
    anchors = _anchors(rays, dir_step, EDGE_DIMS)
    assert set((anchors[:, 2].clamp(0, 95) >> 3).tolist()) == set(range(12))
    x0 = anchors[:, 0].clamp(0, 63)
    assert int((x0 & 1).sum()) > 0 and int(((x0 & 1) == 0).sum()) > 0
    if camera == "low_x_face":
        assert int((anchors[:, 0] < 0).sum()) > 100
    else:  # every ray steps one way in z
        dz = dir_step[..., 2][rays.hit.bool()]
        assert bool((dz > 0).all()) if camera == "z_forward" else bool((dz < 0).all())
    iso = IK.volume_median(as_normalized_volume(vol_u8))
    got = _five(fmt, pool, smap, rays, dir_step, hit, iso)
    assert float(got["alpha"].max()) <= 0.99  # no early-out: rays cross the volume whole
    assert int(got["found"].sum()) > 1000
    _assert_equal(got, _dense(vol_u8, rays, dir_step, hit, iso, got["found"], got["t_hit"]),
                  "the dense kernels")
    _assert_equal(got, _plain(pool, smap, EDGE_DIMS, rays, dir_step, iso, got["found"],
                              got["t_hit"]), "the plain versions")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", sorted(POOLS))
def test_pool_sampler_clamps_an_out_of_range_slab_map_on_cuda(cuda_device, fmt):
    vol_u8 = torch.from_numpy(_edge_volume()).to(cuda_device)
    pool, smap = POOLS[fmt](vol_u8)
    n_slots = pool.shape[0]
    bad = smap.clone()
    bad[0, 1], bad[0, 6], bad[0, 9], bad[0, 11] = -3, n_slots, n_slots + 1000, -(2**31)
    rays, dir_step, hit = _edge_rays(cuda_device, "low_x_face")
    iso = IK.volume_median(as_normalized_volume(vol_u8))
    got = _five(fmt, pool, bad, rays, dir_step, hit, iso)
    clamped = bad.clamp(0, n_slots - 1)
    _assert_equal(got, _five(fmt, pool, clamped, rays, dir_step, hit, iso), "the clamped map")
    _assert_equal(got, _plain(pool, clamped, EDGE_DIMS, rays, dir_step, iso, got["found"],
                              got["t_hit"]), "the plain versions on the clamped map")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", sorted(POOLS))
def test_pool_past_2_to_the_32_words_on_cuda(cuda_device, fmt):
    # a (64, 256, 256) volume's slots moved to the top of a pool of more
    # than 2^32 words (17.2 GB), where 32-bit word offsets would wrap: the
    # kernels must take 64-bit offsets and still equal the dense kernels
    dims = (256, 256, 64)
    u8 = turbulence_volume(dims[::-1], seed=3)
    u8[16:40] = 0
    vol_u8 = torch.from_numpy(u8).to(cuda_device)
    small, smap = POOLS[fmt](vol_u8)
    slot_words = small[0].numel()
    n_big = (2**32 + slot_words - 1) // slot_words + small.shape[0]
    if torch.cuda.mem_get_info()[0] < 1.2 * n_big * slot_words * 4:
        pytest.skip("the card has no room for a pool of more than 2^32 words")
    big = small.new_zeros((n_big, *small.shape[1:]))
    first = n_big - (small.shape[0] - 1)  # slot 1 moves here
    big[first:] = small[1:]
    big_map = torch.where(smap > 0, smap + (first - 1), smap)
    assert big.numel() > 2**32 and int(big_map.max()) * slot_words > 2**32
    rays, dir_step, hit = _edge_rays(cuda_device, "z_forward", dims, 64, 48)
    iso = IK.volume_median(as_normalized_volume(vol_u8))
    got = _five(fmt, big, big_map, rays, dir_step, hit, iso)
    assert int(got["found"].sum()) > 100
    _assert_equal(got, _dense(vol_u8, rays, dir_step, hit, iso, got["found"], got["t_hit"]),
                  "the dense kernels")
    _assert_equal(got, _five(fmt, small, smap, rays, dir_step, hit, iso), "the small pool")
    del big
    torch.cuda.empty_cache()
