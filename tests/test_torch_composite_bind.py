"""The port's ``CompositingPlan.bind``: the exact empty-block skip of the
compositing marches B1, B6 and B7.

A zero sample composites as a no-op (``pa = s - s*a = 0``), so a march may
skip every sample whose block of tap anchors reads only zero bytes.  On CPU
tensors the wrappers run their plain version, which with a bound samples
only outside such blocks: the tests hold it bit for bit against the unbound
march (float32 and uint8 volumes, both wraps, dims that are not multiples of
8, oblique cameras, a sphere and a turbulence dimmed to 2 %, and the pooled
sampler bound from its pool's bytes), show that the skip is real, check the
bound's record of its data, hold ``expand_mip`` and ``occupancy_mip``
against the JAX package's, and ``CompressedRenderer.make_plan(skip_empty=
True)`` against ``skip_empty=False``.  The ``cuda``-marked tests hold B1, B6
and B7 bound against unbound and against the bound plain march on the card.

The machine with the card has no JAX, so this file imports JAX only inside
the test that compares with it; there the card's tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_composite_bind.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.models import CompressedRenderer
from volumerenderer_tpu_torch.ops.blockgrid import BlockBound
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.raycast import composite_march_steps, empty_blocks
from volumerenderer_tpu_torch.ops.sampling import sample_trilinear, slab_pool_sampler

CAMERAS = {
    "front": dict(),
    "oblique": dict(position=(0.3, 0.1, -0.7), front=(-0.3, -0.1, 0.7)),
    "grazing": dict(position=(-0.9, 0.05, 0.02), front=(1.0, -0.05, -0.02)),
}


def _volume(kind, shape):
    if kind == "sphere":
        return as_normalized_volume(sphere_volume(shape, radius=0.3, soft=0.1), device="cpu")
    return as_normalized_volume(turbulence_volume(shape, seed=5), device="cpu") * 0.02


def _plan(shape, camera, wrap, max_samples=96, device="cpu", width=48, height=40):
    rays = generate_rays(Camera(width=width, height=height, **CAMERAS[camera]), device=device)
    Z, Y, X = shape
    return RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z),
                              max_samples=max_samples, wrap=wrap)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("camera", ["front", "oblique"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("kind,shape", [("sphere", (40, 48, 56)), ("sphere", (20, 27, 33)),
                                        ("dim2", (24, 32, 40))])
def test_plain_bound_march_is_bit_equal(kind, shape, dtype, camera, wrap):
    vol = _volume(kind, shape)
    if dtype == "uint8":
        vol = RK.quantize_u8(vol)
    plan = _plan(shape, camera, wrap)
    want = plan.render(vol)
    assert float(want[1].sum()) > 10
    bounds = [plan.bind(vol), plan.bind(vol, mip8=RK.block_max8(vol))]
    # the mip's grid covers each block's footprint with the next block's
    # whole maximum: it skips a subset of what the exact grid skips
    assert bool((bounds[1].grid[..., 1] >= bounds[0].grid[..., 1]).all())
    for bound in bounds:
        assert _same(plan.render(vol, bound=bound), want)
    # the dimmed turbulence holds a nonzero byte in every block: render
    # marches without its bound, which has nothing to skip
    assert bounds[0].has_empty == (kind == "sphere")
    plain = as_normalized_volume(RK.quantize_u8(vol))
    args = (plain, plan.entry_uv, plan.dir_step, plan.hit.bool(), plan.max_samples, wrap)
    assert _same(composite_march_steps(*args, bound=bounds[0]), composite_march_steps(*args))


@pytest.mark.parametrize("fmt", ["pair16", "narrow"])
@pytest.mark.parametrize("kind,shape", [("sphere", (40, 48, 56)), ("sphere", (24, 27, 34)),
                                        ("dim2", (24, 32, 40))])
def test_pooled_bound_march_is_bit_equal(kind, shape, fmt):
    vol = _volume(kind, shape)
    plan = _plan(shape, "oblique", "clamp")
    build = RK.build_slab_pool if fmt == "pair16" else RK.build_slab_pool_narrow
    pool, smap = build(RK.quantize_u8(vol))
    want = plan.render(vol)
    assert _same(plan.render_pooled(pool, smap), want)
    bound = plan.bind(pool=(pool, smap))
    assert torch.equal(bound.grid, plan.bind(vol).grid)
    assert _same(plan.render_pooled(pool, smap, bound=bound), want)
    mip = plan.bind(pool=(pool, smap), mip8=RK.block_max8(vol))
    assert _same(plan.render_pooled(pool, smap, bound=mip), want)
    sampler = slab_pool_sampler(pool, smap, plan.dims)
    args = (sampler, plan.entry_uv, plan.dir_step, plan.hit.bool(), plan.max_samples)
    assert _same(composite_march_steps(*args, bound=bound), composite_march_steps(*args))


def test_bound_skips_the_samples_of_empty_blocks():
    """The skip is real: on a 48^3 sphere whose outside is empty the bound
    plain march takes under 60 % of the samples the unbound one takes, and
    every sample it skips reads 0."""
    vol = as_normalized_volume(sphere_volume((48, 48, 48), radius=0.25, soft=0.05), device="cpu")
    plan = _plan((48, 48, 48), "oblique", "clamp", max_samples=128, width=64, height=48)
    bound = plan.bind(vol)
    taken = {"bound": 0, "unbound": 0}

    def counting(key):
        def sample(uvw):
            alive = uvw[..., 0] > -1  # every position handed over
            taken[key] += int(alive.sum())
            return sample_trilinear(vol, uvw)
        return sample

    args = (plan.entry_uv, plan.dir_step, plan.hit.bool(), plan.max_samples)
    got = composite_march_steps(counting("bound"), *args, bound=bound)
    want = composite_march_steps(counting("unbound"), *args)
    assert _same(got, want) and float(want[1].sum()) > 100
    assert 0 < taken["bound"] < 0.6 * taken["unbound"]
    # an empty block's samples are 0: the grid never skips a nonzero sample
    pos = torch.rand(20000, 3) * 1.2 - 0.1
    skipped = empty_blocks(bound, pos)
    assert int(skipped.sum()) > 1000
    assert float(sample_trilinear(vol, pos[skipped]).abs().max()) == 0.0


def test_bound_from_other_data_dims_or_wrap_raises():
    """The reference fault at isosurface_kernel.py:1104 (a bind's tables
    paired with another bind's) cannot happen here: a bound carries its
    dims, its wrap and the identity of its data, and every render checks
    them."""
    shape = (24, 32, 40)
    vol = _volume("sphere", shape)
    plan = _plan(shape, "front", "clamp")
    bound = plan.bind(vol)
    plan.render(vol, bound=bound)
    for other in (vol.clone(), torch.flip(vol, dims=(0,)).contiguous()):
        with pytest.raises(ValueError, match="other data"):
            plan.render(other, bound=bound)
    pool = RK.build_slab_pool(RK.quantize_u8(vol))
    with pytest.raises(ValueError, match="other data"):
        plan.render_pooled(*pool, bound=bound)
    pooled = plan.bind(pool=pool)
    plan.render_pooled(*pool, bound=pooled)
    with pytest.raises(ValueError, match="other data"):
        plan.render_pooled(*RK.build_slab_pool(RK.quantize_u8(vol)), bound=pooled)
    with pytest.raises(ValueError, match="other data"):
        plan.render(vol, bound=pooled)
    small = _plan((24, 32, 48), "front", "clamp")
    with pytest.raises(ValueError, match="X, Y, Z"):
        small.render(torch.zeros(24, 32, 48), bound=bound)
    rplan = _plan(shape, "front", "repeat")
    with pytest.raises(ValueError, match="wrap"):
        rplan.render(vol, bound=bound)
    with pytest.raises(ValueError, match="wrap"):
        composite_march_steps(vol, plan.entry_uv, plan.dir_step, plan.hit.bool(), bound=bound,
                              wrap="repeat")
    vol.mul_(0.5)
    with pytest.raises(ValueError, match="other data"):
        plan.render(vol, bound=bound)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(), ValueError, "exactly one"),
    (dict(volume="both"), ValueError, "exactly one"),
    (dict(mip8="mip8"), ValueError, "exactly one"),
    (dict(volume=torch.zeros(4, 4, 4)), ValueError, "does not match"),
    (dict(volume="vol", mip8=torch.zeros(2, 2, 2)), ValueError, "block grid"),
    (dict(pool="small"), ValueError, "pool must be"),
    (dict(pool="repeat"), ValueError, "clamp-only"),
])
def test_bind_rejects_bad_arguments(kwargs, error, match):
    shape = (24, 32, 40)
    vol = _volume("sphere", shape)
    plan = _plan(shape, "front", "clamp")
    if kwargs.get("volume") == "both":
        kwargs = dict(volume=vol, pool=RK.build_slab_pool(RK.quantize_u8(vol)))
    elif kwargs.get("mip8") == "mip8":
        kwargs = dict(mip8=RK.block_max8(vol))
    elif kwargs.get("volume") == "vol":
        kwargs = dict(kwargs, volume=vol)
    elif kwargs.get("pool") == "small":
        kwargs = dict(pool=RK.build_slab_pool(RK.quantize_u8(vol[:16])))
    elif kwargs.get("pool") == "repeat":
        plan = _plan(shape, "front", "repeat")
        kwargs = dict(pool=RK.build_slab_pool(RK.quantize_u8(vol)))
    with pytest.raises(error, match=match):
        plan.bind(**kwargs)


@pytest.mark.parametrize("mode", ["compositing", "isosurface"])
def test_bind_refuses_an_inference_mode_volume(mode):
    """An inference-mode tensor has no version counter, so a bound from it
    could not see an in-place write: both plans' binds refuse it."""
    from volumerenderer_tpu_torch.ops.cuda.isosurface_kernel import IsosurfacePlan

    shape = (24, 32, 40)
    plan = _plan(shape, "front", "clamp")
    if mode == "isosurface":
        plan = IsosurfacePlan(plan.entry_uv, plan.entry_uv, plan.hit, plan.dims)
    with torch.inference_mode():
        vol = _volume("sphere", shape)
    args = (vol, 0.5) if mode == "isosurface" else (vol,)
    with pytest.raises(ValueError, match="bind a normal tensor"):
        plan.bind(*args)
    assert plan.bind(vol.clone(), *args[1:]).source


def test_wrappers_reject_a_bad_bound():
    shape = (24, 32, 40)
    vol = _volume("sphere", shape)
    plan = _plan(shape, "front", "clamp")
    bound = plan.bind(vol)
    args = (plan.entry_uv, plan.dir_step, plan.hit)
    bad = BlockBound(bound.dims, "clamp", bound.grid[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="grid"):
        RK.composite_march_cuda(vol, *args, bound=bad)
    with pytest.raises(TypeError, match="BlockBound"):
        RK.composite_march_cuda(RK.quantize_u8(vol), *args, bound=bound.grid)
    from volumerenderer_tpu_torch.ops.cuda.isosurface_kernel import IsosurfacePlan

    # an isosurface plan's bound carries its isovalue: a compositing render refuses it
    iplan = IsosurfacePlan(plan.entry_uv, plan.entry_uv, plan.hit, plan.dims)
    with pytest.raises(ValueError, match="iso 0.5, not None"):
        plan.render(vol, bound=iplan.bind(vol, 0.5))


@pytest.mark.parametrize("shape,reach", [((24, 32, 40), (3, 2)), ((64, 16, 72), (5, 3)),
                                         ((40, 16, 24), (2, 3))])
def test_expand_and_occupancy_mip_equal_jax(shape, reach):
    import jax.numpy as jnp
    from volumerenderer_tpu.ops.pallas import raycast_kernel as JR

    vol_u8 = turbulence_volume(shape, seed=3)
    vol_u8[: shape[0] // 2] = 0
    vol = as_normalized_volume(vol_u8, device="cpu")
    m8 = RK.block_max8(vol)
    got = RK.expand_mip(m8, *reach)
    want = np.asarray(JR.expand_mip(jnp.asarray(m8.numpy()), *reach))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(RK.occupancy_mip(vol, reach[0]).numpy(),
                                  np.asarray(JR.occupancy_mip(jnp.asarray(vol.numpy()),
                                                              reach[0])))


@pytest.fixture(scope="module")
def sphere_tree():
    return TK.build(sphere_volume((32, 32, 32), radius=0.2, soft=0.05), tolerance=2,
                    max_epochs=2)


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("mode", ["compositing", "isosurface"])
def test_make_plan_skip_empty_equals_unbound(sphere_tree, mode, pooled):
    from volumerenderer_tpu_torch.ops.blockgrid import iso_grid_from_mip8

    ren = CompressedRenderer(sphere_tree, "cpu")
    # the tree's mip holds empty blocks, so the compositing plan marches bound
    assert bool((iso_grid_from_mip8(ren.mip8_at(), (32, 32, 32))[..., 1] == 0).any())
    rays = generate_rays(Camera(width=40, height=32, **CAMERAS["oblique"]), device="cpu")
    kw = dict(mode=mode, iso_value=0.5, pooled=pooled, max_samples=64)
    got = ren.make_plan(rays, skip_empty=True, **kw)()
    want = ren.make_plan(rays, skip_empty=False, **kw)()
    assert float(got[1].float().sum()) > 10
    assert _same(got, want)


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_render_isosurface_kernel_skip_empty_is_the_same_image(wrap):
    from volumerenderer_tpu_torch.ops.cuda.isosurface_kernel import render_isosurface_kernel

    vol = _volume("sphere", (24, 32, 40))
    rays = generate_rays(Camera(width=40, height=32, **CAMERAS["oblique"]), device="cpu")
    iso = 0.5
    got, want = (render_isosurface_kernel(vol, rays.entry_uv, rays.direction, rays.hit, iso, 64,
                                          wrap, skip_empty=skip) for skip in (True, False))
    assert int(want[1].sum()) > 50 and _same(got, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("camera", list(CAMERAS))
@pytest.mark.parametrize("kind", ["sphere", "dim2"])
def test_bound_kernels_bit_equal_on_cuda(cuda_device, kind, camera, wrap):
    """B1 on the float32 volume and on its bytes, and (clamp) B6 and B7,
    each bound from its data and from the mip8: bit-equal to the unbound
    kernel and to the bound plain march with the reference transfer."""
    shape = (64, 48, 96)
    vol = _volume(kind, shape).to(cuda_device)
    vol_u8 = RK.quantize_u8(vol)
    plan = _plan(shape, camera, wrap, max_samples=300, device=cuda_device, width=96, height=64)
    args = (plan.entry_uv, plan.dir_step, plan.hit, plan.max_samples, wrap)
    bound = plan.bind(vol)
    color, alpha = composite_march_steps(as_normalized_volume(vol_u8), plan.entry_uv,
                                         plan.dir_step, plan.hit.bool(), plan.max_samples, wrap,
                                         bound=bound)
    plain = (RK.apply_reference_transfer(color, alpha), alpha)
    mip8 = RK.block_max8(vol)
    march = RK.composite_march_cuda
    for v in (vol, vol_u8):
        want = march(v, *args)
        assert _same(want, plain)
        for b in (bound, plan.bind(vol, mip8=mip8)):
            before = (march.launches, march.f32_launches)
            got = march(v, *args, bound=b)
            torch.cuda.synchronize()
            f32 = int(v.dtype == torch.float32)
            assert (march.launches, march.f32_launches) == (before[0] + 1, before[1] + f32)
            assert _same(got, want)
    if wrap != "clamp":
        return
    for build, march in ((RK.build_slab_pool, RK.composite_march_pooled_pair16_cuda),
                         (RK.build_slab_pool_narrow, RK.composite_march_pooled_narrow_cuda)):
        pool = build(vol_u8)
        for b in (plan.bind(pool=pool), plan.bind(pool=pool, mip8=mip8)):
            assert _same(march(*pool, *args, bound=b), plain)
        assert _same(plan.render_pooled(*pool, bound=plan.bind(pool=pool)), plan.render(vol))


@pytest.mark.cuda
def test_bound_goldens_on_cuda(cuda_device):
    """The compositing pin of tests/test_goldens.py through the bound plan."""
    vol = as_normalized_volume(turbulence_volume((32, 32, 32), seed=99), device=cuda_device)
    rays = generate_rays(Camera(width=64, height=48), device=cuda_device)
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (32, 32, 32))
    rgb, alpha = plan.render(vol, bound=plan.bind(vol))
    assert abs(float(rgb.sum()) - 3667.208252) < 0.02
    assert abs(float(alpha.sum()) - 3046.968750) < 0.02
