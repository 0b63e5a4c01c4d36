"""The port's ``IsosurfacePlan.bind``: the isovalue-bound block grid and the
exact skip of the isosurface marches.

On CPU tensors the marches run their plain version, which with a bound
samples only where a block is mixed: the tests hold it bit for bit against
the unbound march, the grid (from a volume or from a slab pool's bytes)
against a numpy brute force over each block's footprint, the
classification against float32 lerps of adversarial taps, the bound's
record of its data against renders of other data, and the bound render
against the JAX package's bound ``IsosurfacePlan``
(its Pallas kernels in interpret mode, as tests/test_pallas_interpret.py
runs them).  The ``cuda``-marked tests hold B2, B8 and B9 bound against
unbound on the card.

The machine with the card has no JAX, so this file imports JAX only inside
the test that compares with it; there the card's tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_iso_bind.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.interop import rays_from_numpy
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.ops.blockgrid import BlockBound
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.isosurface import (classify_blocks, iso_block_grid,
                                                     iso_grid_from_mip8, iso_grid_from_pool,
                                                     iso_march_steps)

CAMERAS = {
    "front": dict(),
    "oblique": dict(position=(0.3, 0.1, -0.7), front=(-0.3, -0.1, 0.7)),
    # almost along the x faces: long paths through few blocks
    "grazing": dict(position=(-0.9, 0.05, 0.02), front=(1.0, -0.05, -0.02)),
}


def _footprint(b, n, wrap):
    j = np.arange(8 * b, 8 * b + 9)
    return np.minimum(j, n - 1) if wrap == "clamp" else j % n


def _brute_grid(vol_u8: np.ndarray, wrap: str) -> np.ndarray:
    Z, Y, X = vol_u8.shape
    nz, ny, nx = (-(-n // 8) for n in (Z, Y, X))
    out = np.zeros((nz, ny, nx, 2), np.uint8)
    for bz in range(nz):
        for by in range(ny):
            for bx in range(nx):
                sub = vol_u8[np.ix_(_footprint(bz, Z, wrap), _footprint(by, Y, wrap),
                                    _footprint(bx, X, wrap))]
                out[bz, by, bx] = sub.min(), sub.max()
    return out


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("shape", [(20, 27, 33), (16, 8, 24), (5, 9, 3)])
def test_grid_equals_brute_force_and_mip8_covers_it(shape, wrap):
    vol_u8 = turbulence_volume(shape, seed=sum(shape))
    grid = iso_block_grid(torch.from_numpy(vol_u8), wrap)
    np.testing.assert_array_equal(grid.numpy(), _brute_grid(vol_u8, wrap))
    # the float volume quantizes to the same bytes
    vol = as_normalized_volume(vol_u8, device="cpu")
    assert torch.equal(iso_block_grid(vol, wrap), grid)
    Z, Y, X = shape
    from_mip = iso_grid_from_mip8(RK.block_max8(vol), (X, Y, Z), wrap)
    assert bool((from_mip[..., 0] == 0).all())
    assert bool((from_mip[..., 1] >= grid[..., 1]).all())


@pytest.mark.parametrize("fmt", ["pair16", "narrow"])
@pytest.mark.parametrize("shape,sparse", [((16, 8, 24), False), ((24, 13, 18), True),
                                          ((8, 9, 10), False)])
def test_pool_grid_equals_the_volume_grid(shape, sparse, fmt):
    """The grid from a slab pool's own bytes equals the grid of the volume
    the pool was built from, with empty and deduplicated slabs; X not a
    multiple of 8."""
    vol_u8 = turbulence_volume(shape, seed=len(shape) + int(sparse))
    if sparse:  # z-blocks 0 and 2 empty, so slabs share slot 0
        vol_u8[:8] = 0
        vol_u8[16:] = 0
    vol = torch.from_numpy(vol_u8)
    build = RK.build_slab_pool if fmt == "pair16" else RK.build_slab_pool_narrow
    pool, smap = build(vol)
    assert bool((smap == 0).any()) == sparse
    Z, Y, X = shape
    grid = iso_grid_from_pool(pool, smap, (X, Y, Z))
    np.testing.assert_array_equal(grid.numpy(), _brute_grid(vol_u8, "clamp"))


def _lerp_f32(c, f):
    """trilerp of ops/sampling.py in numpy float32, the kernel's order."""
    c000, c100, c010, c110, c001, c101, c011, c111 = c
    fx, fy, fz = f
    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def test_classification_margin_holds_for_float32_lerps():
    """Taps of bytes in [lo, hi] and fractions at and next to 0 and 1, and
    random ones: with iso just beyond the half-byte margin on either side,
    no float32 trilerp lands on the other side of iso than its block's."""
    rng = np.random.default_rng(0)
    n = 200_000
    one = np.float32(1.0)
    edges = np.array([0.0, np.nextafter(np.float32(0), one), np.float32(1e-7),
                      np.nextafter(one, np.float32(0)), 1.0, 0.5], np.float32)
    lo = rng.integers(0, 256, n)
    hi = np.minimum(lo + rng.integers(0, 3, n), 255)
    taps = [((lo + rng.integers(0, hi - lo + 1)) * np.float32(1.0 / 255.0)).astype(np.float32)
            for _ in range(8)]
    fracs = [np.where(rng.random(n) < 0.5, edges[rng.integers(0, len(edges), n)],
                      rng.random(n).astype(np.float32)).astype(np.float32) for _ in range(3)]
    s = _lerp_f32(taps, fracs)
    assert s.dtype == np.float32
    for iso255 in (hi + 0.5 + 1e-4, lo - 0.5):
        iso = (iso255 / 255.0).astype(np.float32)
        iso255_f32 = iso * np.float32(255.0)
        below = hi.astype(np.float32) + np.float32(0.5) < iso255_f32
        above = lo.astype(np.float32) - np.float32(0.5) >= iso255_f32
        assert below.sum() + above.sum() > n // 4
        assert bool(((s - iso) < 0)[below].all())
        assert bool(((s - iso) >= 0)[above].all())


def test_classify_blocks_reads_the_anchor_block():
    # z blocks: 0 reads texels 0..8 (all 0), 1 reads 8..16 (mixed), 2 reads
    # 16..23 (all 200); the anchor of z is floor(z * 24 - 0.5), clamped
    vol_u8 = np.zeros((24, 16, 16), np.uint8)
    vol_u8[9:] = 200
    bound = BlockBound((16, 16, 24), "clamp", iso_block_grid(torch.from_numpy(vol_u8)), iso=0.5)
    z = torch.tensor([-0.3, 0.1, 0.3, 0.45, 0.7, 0.8, 1.5])
    uvw = torch.stack([torch.full_like(z, 0.5), torch.full_like(z, 0.5), z], dim=-1)
    below, above = classify_blocks(bound, uvw)
    assert below.tolist() == [True, True, True, False, False, False, False]
    assert above.tolist() == [False, False, False, False, True, True, True]


def _scene(volume, camera, wrap, width=48, height=40):
    vol_u8 = {"sphere": sphere_volume((24, 32, 40), radius=0.3, soft=0.2),
              "turbulence": turbulence_volume((24, 32, 40), seed=5)}[volume]
    vol = as_normalized_volume(vol_u8, device="cpu")
    rays = generate_rays(Camera(width=width, height=height, **CAMERAS[camera]), device="cpu")
    Z, Y, X = vol.shape
    plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), max_samples=64,
                             wrap=wrap)
    return vol, plan


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("camera", list(CAMERAS))
@pytest.mark.parametrize("volume,iso_kind", [("sphere", "byte"), ("turbulence", "median"),
                                             ("turbulence", "byte")])
def test_plain_bound_march_is_bit_equal(volume, iso_kind, camera, wrap):
    vol, plan = _scene(volume, camera, wrap)
    iso = IK.volume_median(vol) if iso_kind == "median" else 128.0 / 255.0
    args = (vol, plan.entry_uv, plan.dir_step, plan.hit.bool(), iso, plan.max_samples, wrap)
    want = iso_march_steps(*args)
    assert 0 < int(want[0].sum())
    for bound in (plan.bind(vol, iso), plan.bind(vol, iso, mip8=RK.block_max8(vol))):
        got = iso_march_steps(*args, bound=bound)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the bound plan renders the same image, dense and (clamp) pooled, each
    # bound from the data it renders
    rgb, found = plan.render(vol, iso)
    got = [plan.render(vol, iso, bound=plan.bind(vol, iso))]
    if wrap == "clamp":
        for build in (RK.build_slab_pool, RK.build_slab_pool_narrow):
            pool = build(RK.quantize_u8(vol))
            got.append(plan.render_pooled(*pool, iso, bound=plan.bind(iso_value=iso, pool=pool)))
    for rgb_b, found_b in got:
        assert torch.equal(rgb_b, rgb) and torch.equal(found_b, found)


def _samples_needed(plan, found, t_hit):
    """The samples the unbound march takes per ray: t_hit + 2 for a hit, the
    steps inside the cube + 1 for a miss."""
    pos, inside = plan.entry_uv, plan.hit.bool()
    steps = torch.zeros(plan.shape, dtype=torch.int64)
    for _ in range(plan.max_samples):
        pos = pos + plan.dir_step
        inside = inside & ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
        steps = steps + inside
    return torch.where(found, t_hit.long() + 2, steps + 1) * plan.hit


def test_bound_skips_most_samples_on_the_sphere():
    """The skip is real: on a 48^3 sphere with a sharp edge, whose outside
    is empty, the bound plain march gathers under half the samples the
    unbound march needs.  (A small turbulence has few one-sided 8^3 blocks:
    its finest octave is a few voxels wide.)"""
    from volumerenderer_tpu_torch.ops.sampling import sample_trilinear

    vol = as_normalized_volume(sphere_volume((48, 48, 48), radius=0.25, soft=0.05), device="cpu")
    rays = generate_rays(Camera(width=64, height=48, **CAMERAS["oblique"]), device="cpu")
    plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (48, 48, 48),
                             max_samples=128)
    iso = 128.0 / 255.0
    gathered = []

    def counting(uvw):
        gathered.append(uvw[..., 0].numel())
        return sample_trilinear(vol, uvw)

    found, t_hit = iso_march_steps(counting, plan.entry_uv, plan.dir_step, plan.hit.bool(), iso,
                                   plan.max_samples, bound=plan.bind(vol, iso))
    want = iso_march_steps(vol, plan.entry_uv, plan.dir_step, plan.hit.bool(), iso,
                           plan.max_samples)
    assert torch.equal(found, want[0]) and torch.equal(t_hit, want[1])
    assert int(found.sum()) > 500
    assert 0 < sum(gathered) < 0.5 * int(_samples_needed(plan, found, t_hit).sum())


@pytest.mark.parametrize("kind", ["median", "byte"])
def test_bound_render_matches_jax_bound_plan(kind):
    """``plan.render(vol, iso, bound=plan.bind(vol, iso))`` vs the JAX
    package's bound plan (``bind`` -> ``render(words=)``, the phased march
    with its min/max gates, interpret mode): equal hit masks and t_hit, rgb
    within test_torch_isosurface_kernel.py's 2e-3."""
    from jax.experimental.pallas import tpu as pltpu

    import volumerenderer_tpu as J
    from volumerenderer_tpu.ops.pallas import isosurface_kernel as JK
    from volumerenderer_tpu.ops.pallas.raycast_kernel import _untile
    from conftest import EAGER_INTERPRET

    vol_u8 = turbulence_volume((8, 16, 128), seed=3)
    rays = J.generate_rays(J.Camera(width=64, height=32))
    entry_uv, direction, hit = (np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))
    Z, Y, X = vol_u8.shape
    H, W = hit.shape
    vol_t = as_normalized_volume(vol_u8, device="cpu")
    iso = IK.volume_median(vol_t) if kind == "median" else 120.0 / 255.0
    vol_j = J.as_normalized_volume(vol_u8)
    with pltpu.force_tpu_interpret_mode(EAGER_INTERPRET):
        plan_j = JK.IsosurfacePlan(entry_uv, direction, hit, (X, Y, Z), max_samples=24)
        words = plan_j.bind(vol_j, iso)
        assert plan_j.gwords is not None
        found_tiles, t_hit_tiles = JK.march_phased(
            plan_j.rays_packed, words, plan_j.gwords, plan_j.state0, plan_j.texit, vol_j,
            np.full((1, 1), iso * 255.0, np.float32), plan_j.dims, plan_j.max_samples + 1,
            plan_j.win_z, plan_j.win_y, plan_j.group, plan_j.lanes, xwords=plan_j.xwords)
        rgb_j, found_j = plan_j.render(vol_j, iso, words=words)
    t_hit_j = np.asarray(_untile(t_hit_tiles, H, W, plan_j.lanes)).astype(np.int32)

    rt = rays_from_numpy(entry_uv, direction, hit, device="cpu")
    plan_t = IK.IsosurfacePlan(rt.entry_uv, rt.direction, rt.hit, (X, Y, Z), max_samples=24)
    bound = plan_t.bind(vol_t, iso)
    rgb_t, found_t = plan_t.render(vol_t, iso, bound=bound)
    _, t_hit_t = IK.iso_march_cuda(RK.quantize_u8(vol_t), plan_t.entry_uv, plan_t.dir_step,
                                   plan_t.hit, iso, plan_t.max_samples, bound=bound)
    assert int(found_t.sum()) > 50
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=2e-3, rtol=0)
    np.testing.assert_array_equal(np.where(found_t.numpy(), t_hit_t.numpy(), -1),
                                  np.where(np.asarray(found_j), t_hit_j, -1))


def test_bound_for_another_isovalue_dims_or_wrap_raises():
    """The reference fault at isosurface_kernel.py:1104 (a bind's tables
    paired with another bind's) cannot happen: a bound carries its isovalue,
    dims and wrap, and every march checks them."""
    vol, plan = _scene("turbulence", "front", "clamp")
    bound = plan.bind(vol, 0.5)
    with pytest.raises(ValueError, match="iso"):
        plan.render(vol, 0.6, bound=bound)
    pool, smap = RK.build_slab_pool(RK.quantize_u8(vol))
    with pytest.raises(ValueError, match="iso"):
        plan.render_pooled(pool, smap, 0.6, bound=plan.bind(iso_value=0.5, pool=(pool, smap)))
    vol2 = torch.zeros(24, 32, 48)
    rays = generate_rays(Camera(width=48, height=40), device="cpu")
    plan2 = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (48, 32, 24))
    with pytest.raises(ValueError, match="X, Y, Z"):
        plan2.render(vol2, 0.5, bound=bound)
    _, rplan = _scene("turbulence", "front", "repeat")
    with pytest.raises(ValueError, match="wrap"):
        rplan.render(vol, 0.5, bound=bound)
    with pytest.raises(ValueError, match="wrap"):
        iso_march_steps(vol, plan.entry_uv, plan.dir_step, plan.hit.bool(), 0.5, bound=bound,
                        wrap="repeat")


def test_bound_made_from_other_data_raises():
    """A bound records the tensors it was made from: the same bound with a
    second volume of the same dims, with its own volume written in place
    since, with a pool when it was bound from a volume, or with another
    pool, raises."""
    vol, plan = _scene("turbulence", "front", "clamp")
    bound = plan.bind(vol, 0.5)
    plan.render(vol, 0.5, bound=bound)
    for other in (vol.clone(), torch.flip(vol, dims=(0,)).contiguous()):
        with pytest.raises(ValueError, match="other data"):
            plan.render(other, 0.5, bound=bound)
    pool = RK.build_slab_pool(RK.quantize_u8(vol))
    with pytest.raises(ValueError, match="other data"):
        plan.render_pooled(*pool, 0.5, bound=bound)
    pooled = plan.bind(iso_value=0.5, pool=pool)
    plan.render_pooled(*pool, 0.5, bound=pooled)
    with pytest.raises(ValueError, match="other data"):
        plan.render_pooled(*RK.build_slab_pool(RK.quantize_u8(vol)), 0.5, bound=pooled)
    with pytest.raises(ValueError, match="other data"):
        plan.render(vol, 0.5, bound=pooled)
    vol.mul_(0.5)
    with pytest.raises(ValueError, match="other data"):
        plan.render(vol, 0.5, bound=bound)


def test_one_bound_serves_every_plan_of_its_dims_and_wrap():
    """The grid depends on the volume and the wrap only: a bound from one
    plan renders every camera's plan of the same dims bit-equal to
    unbound."""
    vol, plan = _scene("turbulence", "front", "clamp")
    iso = IK.volume_median(vol)
    bound = plan.bind(vol, iso)
    for camera in CAMERAS:
        _, other = _scene("turbulence", camera, "clamp")
        want = other.render(vol, iso)
        got = other.render(vol, iso, bound=bound)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(), ValueError, "exactly one"),
    (dict(volume="both"), ValueError, "exactly one"),
    (dict(mip8="mip8"), ValueError, "exactly one"),
    (dict(volume=torch.zeros(4, 4, 4)), ValueError, "does not match"),
    (dict(volume="vol", mip8=torch.zeros(2, 2, 2)), ValueError, "block grid"),
    (dict(volume="vol", iso_value=float("nan")), ValueError, "iso"),
    (dict(pool="small"), ValueError, "pool must be"),
    (dict(pool="repeat"), ValueError, "clamp-only"),
])
def test_bind_rejects_bad_arguments(kwargs, error, match):
    vol, plan = _scene("sphere", "front", "clamp")
    if kwargs.get("volume") == "both":
        kwargs = dict(volume=vol, pool=RK.build_slab_pool(RK.quantize_u8(vol)))
    elif kwargs.get("mip8") == "mip8":
        kwargs = dict(mip8=RK.block_max8(vol))
    elif kwargs.get("volume") == "vol":
        kwargs = dict(kwargs, volume=vol)
    elif kwargs.get("pool") == "small":
        kwargs = dict(pool=RK.build_slab_pool(RK.quantize_u8(vol[:16])))
    elif kwargs.get("pool") == "repeat":
        _, plan = _scene("sphere", "front", "repeat")
        kwargs = dict(pool=RK.build_slab_pool(RK.quantize_u8(vol)))
    with pytest.raises(error, match=match):
        plan.bind(**kwargs)


def test_wrapper_rejects_a_bad_grid():
    vol, plan = _scene("sphere", "front", "clamp")
    bound = plan.bind(vol, 0.5)
    vol_u8 = RK.quantize_u8(vol)
    bad = BlockBound(bound.dims, "clamp", bound.grid[:, :, :-1].contiguous(), iso=0.5)
    with pytest.raises(ValueError, match="grid"):
        IK.iso_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit, 0.5, bound=bad)
    with pytest.raises(TypeError, match="BlockBound"):
        IK.iso_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit, 0.5,
                          bound=bound.grid)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("camera", ["front", "oblique", "grazing"])
def test_bound_kernels_bit_equal_on_cuda(cuda_device, camera, wrap):
    """B2 (and, clamp, B8 and B9) with a bound from the volume (from each
    pool) and from its mip8: bit-equal to the unbound B2, which equals the
    plain march."""
    vol_u8 = torch.from_numpy(turbulence_volume((64, 48, 96), seed=1)).to(cuda_device)
    vol = as_normalized_volume(vol_u8)
    rays = generate_rays(Camera(width=96, height=64, **CAMERAS[camera]), device=cuda_device)
    Z, Y, X = vol_u8.shape
    plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), wrap=wrap)
    pools = {"pair16": RK.build_slab_pool(vol_u8), "narrow": RK.build_slab_pool_narrow(vol_u8)}
    for iso in (IK.volume_median(vol), 40.0 / 255.0):
        args = (plan.entry_uv, plan.dir_step, plan.hit, iso, plan.max_samples, wrap)
        want = IK.iso_march_cuda(vol_u8, *args)
        plain = iso_march_steps(vol, plan.entry_uv, plan.dir_step, plan.hit.bool(), iso,
                                plan.max_samples, wrap)
        assert torch.equal(want[0], plain[0]) and torch.equal(want[1], plain[1])
        mip8 = RK.block_max8(vol)
        for bound in (plan.bind(vol, iso), plan.bind(vol, iso, mip8=mip8)):
            before = IK.iso_march_cuda.launches
            got = IK.iso_march_cuda(vol_u8, *args, bound=bound)
            torch.cuda.synchronize()
            assert IK.iso_march_cuda.launches == before + 1
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if wrap != "clamp":
            continue
        for fmt, march in (("pair16", IK.iso_march_pooled_pair16_cuda),
                           ("narrow", IK.iso_march_pooled_narrow_cuda)):
            pooled = plan.bind(iso_value=iso, pool=pools[fmt])
            assert torch.equal(pooled.grid, plan.bind(vol, iso).grid), fmt
            for bound in (pooled, plan.bind(iso_value=iso, pool=pools[fmt], mip8=mip8)):
                got = march(*pools[fmt], *args, bound=bound)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), fmt


@pytest.mark.cuda
def test_bound_golden_on_cuda(cuda_device):
    """The isosurface pin of tests/test_goldens.py through the bound plan."""
    vol = as_normalized_volume(turbulence_volume((32, 32, 32), seed=99), device=cuda_device)
    rays = generate_rays(Camera(width=64, height=48), device=cuda_device)
    plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (32, 32, 32))
    rgb, found = plan.render(vol, bound=plan.bind(vol))
    assert abs(float(rgb.sum()) - 9185.606445) < 0.05
    assert int(found.sum()) == 18
