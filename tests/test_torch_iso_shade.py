"""The isosurface march's near bracket and the shade that reads it.

The marches (B2, and B8/B9 on a slab pool) return with ``with_near`` each
hit's position at its crossing, which the shade (B3, the pooled shade) takes
instead of rebuilding it by ``t_hit + 1`` additions.  Bars, all bit for bit:
``near`` equals a numpy float32 replay of those additions from ``entry_uv``,
bound and unbound, in both wraps; the shade from ``near`` equals the shade
from ``(found, t_hit)``; ``found``/``t_hit`` are the same with ``near`` asked
for or not.  ``IsosurfacePlan.render`` and ``render_pooled`` take this route,
and stay within ``tests/test_torch_isosurface.py``'s bars of the JAX
package's ``render_isosurface`` (equal hit masks, rgb within 1e-4).

On CPU tensors the wrappers run the plain versions; the ``cuda``-marked tests
hold the kernels to the same bars where there is a card.  This file imports
JAX only inside the tests that compare with it, so the card's tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_iso_shade.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.isosurface import iso_march_steps, shade_hits
from volumerenderer_tpu_torch.ops.raycast import step_sizes
from volumerenderer_tpu_torch.ops.sampling import slab_pool_sampler

VOL_SHAPE = (24, 32, 40)  # (Z, Y, X)
POOLS = {"pair16": (RK.build_slab_pool, IK.iso_march_pooled_pair16_cuda),
         "narrow": (RK.build_slab_pool_narrow, IK.iso_march_pooled_narrow_cuda)}
COUNTERS = (IK.iso_march_cuda, IK.iso_shade_cuda, IK.iso_march_pooled_narrow_cuda,
            IK.iso_march_pooled_pair16_cuda, IK.iso_shade_pooled_cuda)


def _scene(device, width=48, height=32, shape=VOL_SHAPE):
    """An oblique camera on a turbulence whose z-blocks 0 is empty (slot-0
    reads in a pool), at the volume's median."""
    u8 = turbulence_volume(shape, seed=5)
    u8[:8] = 0
    vol_u8 = torch.from_numpy(u8).to(device)
    rays = generate_rays(Camera(width=width, height=height, position=(0.4, 0.15, -0.62),
                                front=(-0.4, -0.15, 0.62)), device=device)
    Z, Y, X = vol_u8.shape
    dir_step = (rays.direction * step_sizes((X, Y, Z), device)).contiguous()
    iso = IK.volume_median(as_normalized_volume(vol_u8))
    return vol_u8, rays, dir_step, rays.hit.to(torch.uint8), iso


def _replayed_near(entry_uv, dir_step, found, t_hit):
    """Each hit's entry plus t_hit + 1 additions of dir_step, in numpy
    float32 (one rounding per addition), and entry for a miss."""
    near = entry_uv.cpu().numpy().astype(np.float32)
    d = dir_step.cpu().numpy().astype(np.float32)
    n_add = np.where(found.cpu().numpy(), t_hit.cpu().numpy().astype(np.int64) + 1, 0)
    for k in range(1, int(n_add.max()) + 1 if n_add.size else 1):
        m = n_add >= k
        near[m] = near[m] + d[m]
    return torch.from_numpy(near)


def _bits_equal_on_hits(near, want, found):
    f = found.cpu()
    return torch.equal(near.cpu()[f].view(torch.int32), want[f].view(torch.int32))


def _bound(vol_u8, rays, iso, wrap, pool=None):
    Z, Y, X = vol_u8.shape
    plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), wrap=wrap)
    if pool is not None:
        return plan.bind(iso_value=iso, pool=pool)
    return plan.bind(vol_u8, iso)


# -- the plain versions (CPU) -------------------------------------------------

@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_plain_near_is_the_replayed_additions(wrap, bound):
    vol_u8, rays, dir_step, hit, iso = _scene("cpu")
    vol = as_normalized_volume(vol_u8)
    ib = _bound(vol_u8, rays, iso, wrap) if bound else None
    found, t_hit, near = iso_march_steps(vol, rays.entry_uv, dir_step, rays.hit, iso, wrap=wrap,
                                         bound=ib, with_near=True)
    assert int(found.sum()) > 100
    assert near.shape == rays.entry_uv.shape and near.dtype == torch.float32
    want = _replayed_near(rays.entry_uv, dir_step, found, t_hit)
    assert torch.equal(near.view(torch.int32), want.view(torch.int32))  # misses: entry_uv
    assert all(torch.equal(a, b) for a, b in zip(
        (found, t_hit), iso_march_steps(vol, rays.entry_uv, dir_step, rays.hit, iso, wrap=wrap,
                                        bound=ib)))


@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("fmt", sorted(POOLS))
def test_pooled_wrapper_plain_near_is_the_replayed_additions(fmt, bound):
    vol_u8, rays, dir_step, hit, iso = _scene("cpu")
    build, march = POOLS[fmt]
    pool = build(vol_u8)
    ib = _bound(vol_u8, rays, iso, "clamp", pool) if bound else None
    before = [f.launches for f in COUNTERS]
    found, t_hit, near = march(*pool, rays.entry_uv, dir_step, hit, iso, bound=ib,
                               with_near=True)
    assert int(found.sum()) > 100
    assert _bits_equal_on_hits(near, _replayed_near(rays.entry_uv, dir_step, found, t_hit),
                               found)
    f2, t2 = march(*pool, rays.entry_uv, dir_step, hit, iso, bound=ib)
    assert torch.equal(found, f2) and torch.equal(t_hit, t2)
    assert [f.launches for f in COUNTERS] == before  # no kernel on CPU


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_plain_shade_from_near_equals_the_chain(wrap):
    vol_u8, rays, dir_step, hit, iso = _scene("cpu")
    vol = as_normalized_volume(vol_u8)
    found, t_hit, near = iso_march_steps(vol, rays.entry_uv, dir_step, rays.hit, iso, wrap=wrap,
                                         with_near=True)
    chain = shade_hits(vol, rays.entry_uv, dir_step, rays.direction, found, t_hit, iso, wrap)
    # a miss's near is never read: NaN there changes nothing
    near = torch.where(found[..., None], near, torch.full_like(near, float("nan")))
    got = shade_hits(vol, rays.entry_uv, dir_step, rays.direction, found, None, iso, wrap,
                     near=near)
    assert torch.equal(got, chain)
    assert int(((got < 1.0).any(dim=-1)).sum()) > 100


@pytest.mark.parametrize("fmt", sorted(POOLS))
def test_wrappers_cpu_route_from_near(fmt):
    """The CPU route of every wrapper: the march's near, then the shade from
    it, equal to the chain route on the volume and on each pool."""
    vol_u8, rays, dir_step, hit, iso = _scene("cpu")
    build, march = POOLS[fmt]
    pool, smap = build(vol_u8)
    before = [f.launches for f in COUNTERS]
    found, t_hit, near = IK.iso_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, iso,
                                           with_near=True)
    args = (rays.entry_uv, dir_step, rays.direction, found)
    chain = IK.iso_shade_cuda(vol_u8, *args, t_hit, iso)
    assert torch.equal(IK.iso_shade_cuda(vol_u8, *args, None, iso, near=near), chain)
    fp, tp, near_p = march(pool, smap, rays.entry_uv, dir_step, hit, iso, with_near=True)
    assert torch.equal(fp, found) and torch.equal(tp, t_hit) and torch.equal(near_p, near)
    assert torch.equal(IK.iso_shade_pooled_cuda(pool, smap, *args, None, iso, near=near_p),
                       chain)
    assert torch.equal(IK.iso_shade_pooled_cuda(pool, smap, *args, t_hit, iso), chain)
    assert [f.launches for f in COUNTERS] == before


def _jax_rays(width, height):
    import volumerenderer_tpu as J

    rays = J.generate_rays(J.Camera(width=width, height=height, position=(0.3, -0.2, -0.68),
                                    front=(-0.3, 0.2, 0.68)))
    return tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


@pytest.mark.parametrize("route", ["render_clamp", "render_repeat", "render_pooled_pair16",
                                   "render_pooled_narrow"])
def test_plan_routes_match_jax_render_isosurface(route):
    """IsosurfacePlan.render and render_pooled (the near route) against the
    JAX package's jnp render_isosurface: equal hit masks, rgb within 1e-4."""
    import volumerenderer_tpu as J
    from volumerenderer_tpu.ops import isosurface as JI

    u8 = turbulence_volume(VOL_SHAPE, seed=5)
    entry_uv, direction, hit = _jax_rays(40, 32)
    wrap = "repeat" if route == "render_repeat" else "clamp"
    iso = float(np.median(u8.astype(np.float32) / np.float32(255)))
    rgb_j, f_j = JI.render_isosurface(J.as_normalized_volume(u8), entry_uv, direction, hit,
                                      iso_value=iso, wrap=wrap)
    Z, Y, X = u8.shape
    plan = IK.IsosurfacePlan(*(torch.from_numpy(np.array(a)) for a in (entry_uv, direction, hit)),
                             (X, Y, Z), wrap=wrap)
    vol = as_normalized_volume(u8, device="cpu")
    if route.startswith("render_pooled"):
        build = POOLS[route.rsplit("_", 1)[1]][0]
        rgb_t, f_t = plan.render_pooled(*build(vol), iso)
    else:
        rgb_t, f_t = plan.render(vol, iso)
    assert int(f_t.sum()) > 100
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-4, rtol=0)


_BAD_NEAR = [
    ("shape", lambda n: n[:, :-1].contiguous(), ValueError, "near"),
    ("channels", lambda n: n[..., :2].contiguous(), ValueError, "near"),
    ("dtype", lambda n: n.double(), ValueError, "float32"),
    ("device", lambda n: torch.empty(n.shape, device="meta"), ValueError, "is on meta"),
    ("strided", lambda n: n.transpose(0, 1), ValueError, "contiguous"),
    ("numpy", lambda n: n.numpy(), TypeError, "torch.Tensor"),
]


@pytest.mark.parametrize("kind,bad,exc,match", _BAD_NEAR)
@pytest.mark.parametrize("shade", ["dense", "pooled"])
def test_shade_wrappers_reject_a_bad_near(shade, kind, bad, exc, match):
    vol_u8, rays, dir_step, hit, iso = _scene("cpu", 16, 12)
    found, t_hit, near = IK.iso_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, iso,
                                           with_near=True)
    data = (vol_u8,) if shade == "dense" else RK.build_slab_pool(vol_u8)
    fn = IK.iso_shade_cuda if shade == "dense" else IK.iso_shade_pooled_cuda
    with pytest.raises(exc, match=match):
        fn(*data, rays.entry_uv, dir_step, rays.direction, found, t_hit, iso, near=bad(near))


@pytest.mark.parametrize("shade", ["dense", "pooled"])
def test_shade_wrappers_need_near_or_t_hit(shade):
    vol_u8, rays, dir_step, hit, iso = _scene("cpu", 16, 12)
    found, _ = IK.iso_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, iso)
    data = (vol_u8,) if shade == "dense" else RK.build_slab_pool(vol_u8)
    fn = IK.iso_shade_cuda if shade == "dense" else IK.iso_shade_pooled_cuda
    with pytest.raises(ValueError, match="near"):
        fn(*data, rays.entry_uv, dir_step, rays.direction, found, None, iso)


# -- the kernels (a CUDA card) ------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _nan_near_march(vol_u8, rays, dir_step, hit, iso, wrap):
    """B2 launched by hand into a near buffer filled with NaN, with no grid:
    (found, t_hit, near)."""
    H, W = hit.shape
    Z, Y, X = vol_u8.shape
    dev = vol_u8.device
    found = torch.empty((H, W), dtype=torch.uint8, device=dev)
    t_hit = torch.empty((H, W), dtype=torch.int32, device=dev)
    near = torch.full((H, W, 3), float("nan"), device=dev)
    IK.launch(IK._march_launcher, "iso_march", dev, rays.entry_uv.data_ptr(),
              dir_step.data_ptr(), hit.data_ptr(), vol_u8.data_ptr(), None, H, W, X, Y, Z,
              IK.MAX_SAMPLES, int(wrap == "repeat"), float(iso), found.data_ptr(),
              t_hit.data_ptr(), near.data_ptr())
    return found.view(torch.bool), t_hit, near


@pytest.mark.cuda
@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_kernel_near_is_the_replayed_additions_on_cuda(cuda_device, wrap, bound):
    vol_u8, rays, dir_step, hit, iso = _scene(cuda_device, 96, 64, (64, 48, 64))
    ib = _bound(vol_u8, rays, iso, wrap) if bound else None
    before = IK.iso_march_cuda.launches
    found, t_hit, near = IK.iso_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, iso,
                                           wrap=wrap, bound=ib, with_near=True)
    f2, t2 = IK.iso_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, iso, wrap=wrap, bound=ib)
    torch.cuda.synchronize()
    assert IK.iso_march_cuda.launches == before + 2
    assert int(found.sum()) > 1000
    assert torch.equal(found, f2) and torch.equal(t_hit, t2)
    assert _bits_equal_on_hits(near, _replayed_near(rays.entry_uv, dir_step, found, t_hit),
                               found)


@pytest.mark.cuda
@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("fmt", sorted(POOLS))
def test_pooled_kernel_near_is_the_replayed_additions_on_cuda(cuda_device, fmt, bound):
    vol_u8, rays, dir_step, hit, iso = _scene(cuda_device, 96, 64, (64, 48, 64))
    build, march = POOLS[fmt]
    pool = build(vol_u8)
    ib = _bound(vol_u8, rays, iso, "clamp", pool) if bound else None
    found, t_hit, near = march(*pool, rays.entry_uv, dir_step, hit, iso, bound=ib,
                               with_near=True)
    f_d, t_d, near_d = IK.iso_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, iso,
                                         with_near=True)
    torch.cuda.synchronize()
    assert int(found.sum()) > 1000
    assert torch.equal(found, f_d) and torch.equal(t_hit, t_d)
    assert _bits_equal_on_hits(near, _replayed_near(rays.entry_uv, dir_step, found, t_hit),
                               found)
    assert _bits_equal_on_hits(near, near_d.cpu(), found)


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_shade_from_near_bit_equal_to_chain_and_pools_on_cuda(cuda_device, wrap):
    """B3 from a near buffer that holds NaN wherever the march did not write
    (every miss) equals B3's chain instantiation and, on both pools, the
    pooled shade from near and from t_hit; the plain shade within 1e-4."""
    vol_u8, rays, dir_step, hit, iso = _scene(cuda_device, 96, 64, (64, 48, 64))
    found, t_hit, near = _nan_near_march(vol_u8, rays, dir_step, hit, iso, wrap)
    f2, t2 = IK.iso_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, iso, wrap=wrap)
    assert torch.equal(found, f2) and torch.equal(t_hit, t2)
    assert bool(torch.isnan(near[~found]).all()) and not bool(torch.isnan(near[found]).any())
    args = (rays.entry_uv, dir_step, rays.direction, found)
    before = IK.iso_shade_cuda.launches
    rgb = IK.iso_shade_cuda(vol_u8, *args, None, iso, wrap, near=near)
    chain = IK.iso_shade_cuda(vol_u8, *args, t_hit, iso, wrap)
    torch.cuda.synchronize()
    assert IK.iso_shade_cuda.launches == before + 2
    assert int(found.sum()) > 1000 and torch.equal(rgb, chain)
    plain = shade_hits(as_normalized_volume(vol_u8), rays.entry_uv, dir_step, rays.direction,
                       found, t_hit, iso, wrap)
    assert float((rgb - plain).abs().max()) <= 1e-4
    if wrap == "repeat":
        return  # the pools are clamp-only
    for fmt, (build, _) in POOLS.items():
        pool, smap = build(vol_u8)
        assert torch.equal(IK.iso_shade_pooled_cuda(pool, smap, *args, None, iso, near=near),
                           rgb), fmt
        assert torch.equal(IK.iso_shade_pooled_cuda(pool, smap, *args, t_hit, iso), rgb), fmt
        assert torch.equal(shade_hits(slab_pool_sampler(pool, smap, (64, 48, 64)),
                                      rays.entry_uv, dir_step, rays.direction, found, t_hit,
                                      iso), plain), fmt


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["render", "render_pooled"])
def test_plan_routes_launch_the_near_route_on_cuda(cuda_device, route):
    """render and render_pooled on the card: one march with near and one
    shade from it, the image equal to the chain route's."""
    vol_u8, rays, dir_step, hit, iso = _scene(cuda_device, 96, 64, (64, 48, 64))
    Z, Y, X = vol_u8.shape
    plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    vol = as_normalized_volume(vol_u8)
    before = [f.launches for f in COUNTERS]
    if route == "render":
        rgb, found = plan.render(vol, iso)
        march, shade = IK.iso_march_cuda, IK.iso_shade_cuda
        f, t = IK.iso_march_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.hit, iso)
        chain = IK.iso_shade_cuda(vol_u8, plan.entry_uv, plan.dir_step, plan.direction, f, t,
                                  iso)
    else:
        pool, smap = RK.build_slab_pool(vol_u8)
        rgb, found = plan.render_pooled(pool, smap, iso)
        march, shade = IK.iso_march_pooled_pair16_cuda, IK.iso_shade_pooled_cuda
        f, t = march(pool, smap, plan.entry_uv, plan.dir_step, plan.hit, iso)
        chain = IK.iso_shade_pooled_cuda(pool, smap, plan.entry_uv, plan.dir_step,
                                         plan.direction, f, t, iso)
    torch.cuda.synchronize()
    counts = dict(zip(COUNTERS, before))
    assert march.launches == counts[march] + 2 and shade.launches == counts[shade] + 2
    assert torch.equal(found, f) and torch.equal(rgb, chain) and int(found.sum()) > 1000
