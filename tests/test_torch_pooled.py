"""The pooled marches' and the pooled shade's wrappers on CPU tensors, where
they run their plain versions: the sampler-generic marches of
``ops/raycast.py`` and ``ops/isosurface.py`` with ``slab_pool_sampler``.

On oblique cameras they must be bit-equal to the dense plain paths on the
volume the pool was built from, and ``render_pooled`` to ``render``.  The
kernels run only on a CUDA device (tests/test_torch_pooled_kernel.py)."""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.isosurface import iso_march_steps, shade_hits
from volumerenderer_tpu_torch.ops.raycast import apply_reference_transfer, composite_march_steps

VOL_SHAPE = (16, 16, 32)  # (Z, Y, X)
CAMERAS = {
    "oblique": dict(position=(0.45, 0.2, -0.6), front=(-0.45, -0.2, 0.6)),
    "side_grazing": dict(position=(0.74, 0.05, -0.1), front=(-0.74, -0.05, 0.1)),
}
POOLS = {"pair16": RK.build_slab_pool, "narrow": RK.build_slab_pool_narrow}
COUNTERS = (RK.composite_march_pooled_narrow_cuda, RK.composite_march_pooled_pair16_cuda,
            IK.iso_march_pooled_narrow_cuda, IK.iso_march_pooled_pair16_cuda,
            IK.iso_shade_pooled_cuda)


def _scene(camera, volume="turbulence"):
    if volume == "turbulence":
        u8 = turbulence_volume(VOL_SHAPE, seed=4)
        u8[:8] = 0  # an empty z-block; its slab is kept for block 1's rows
    else:
        u8 = sphere_volume(VOL_SHAPE, radius=0.3, soft=0.2)
    rays = generate_rays(Camera(width=40, height=24, **CAMERAS[camera]), device="cpu")
    return as_normalized_volume(u8, device="cpu"), rays


@pytest.mark.parametrize("fmt", sorted(POOLS))
@pytest.mark.parametrize("camera", sorted(CAMERAS))
def test_pooled_compositing_plain_equals_dense(camera, fmt):
    vol, rays = _scene(camera)
    Z, Y, X = vol.shape
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    pool, smap = POOLS[fmt](vol)
    before = [f.launches for f in COUNTERS]
    march = (RK.composite_march_pooled_pair16_cuda if fmt == "pair16"
             else RK.composite_march_pooled_narrow_cuda)
    got = march(pool, smap, plan.entry_uv, plan.dir_step, plan.hit)
    color, alpha = composite_march_steps(vol, plan.entry_uv, plan.dir_step, rays.hit)
    want = (apply_reference_transfer(color, alpha), alpha)
    assert float(want[1].sum()) > 10
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rgb_p, a_p = plan.render_pooled(pool, smap)
    rgb_d, a_d = plan.render(vol)
    assert torch.equal(rgb_p, rgb_d) and torch.equal(a_p, a_d)
    assert [f.launches for f in COUNTERS] == before  # no kernel on CPU


@pytest.mark.parametrize("fmt", sorted(POOLS))
@pytest.mark.parametrize("camera,volume,iso", [("oblique", "turbulence", "median"),
                                               ("side_grazing", "turbulence", "median"),
                                               ("oblique", "sphere", 0.5)])
def test_pooled_isosurface_plain_equals_dense(camera, volume, iso, fmt):
    vol, rays = _scene(camera, volume)
    Z, Y, X = vol.shape
    iso = IK.volume_median(vol) if iso == "median" else iso
    plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    pool, smap = POOLS[fmt](vol)
    march = (IK.iso_march_pooled_pair16_cuda if fmt == "pair16"
             else IK.iso_march_pooled_narrow_cuda)
    found, t_hit = march(pool, smap, plan.entry_uv, plan.dir_step, plan.hit, iso)
    found_d, t_hit_d = iso_march_steps(vol, plan.entry_uv, plan.dir_step, rays.hit, iso)
    assert int(found_d.sum()) > 20
    assert torch.equal(found, found_d) and torch.equal(t_hit, t_hit_d)
    rgb = IK.iso_shade_pooled_cuda(pool, smap, plan.entry_uv, plan.dir_step, plan.direction,
                                   found, t_hit, iso)
    assert torch.equal(rgb, shade_hits(vol, plan.entry_uv, plan.dir_step, plan.direction,
                                       found, t_hit, iso))
    rgb_p, found_p = plan.render_pooled(pool, smap, iso)
    rgb_d, found_dd = plan.render(vol, iso)
    assert torch.equal(rgb_p, rgb_d) and torch.equal(found_p, found_dd)


def _pooled_inputs(fmt="pair16"):
    vol, rays = _scene("oblique")
    Z, Y, X = vol.shape
    plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    pool, smap = POOLS[fmt](vol)
    return dict(pool=pool, slab_map=smap, entry_uv=plan.entry_uv, dir_step=plan.dir_step,
                hit=plan.hit), plan


@pytest.mark.parametrize("march", [RK.composite_march_pooled_narrow_cuda,
                                   RK.composite_march_pooled_pair16_cuda])
def test_composite_pooled_wrappers_reject_bad_inputs(march):
    fmt = "narrow" if "narrow" in march.__name__ else "pair16"
    other = "pair16" if fmt == "narrow" else "narrow"
    kw, _ = _pooled_inputs(fmt)
    with pytest.raises(ValueError, match="clamp-only"):
        march(**kw, wrap="repeat")
    with pytest.raises(ValueError, match="unknown wrap"):
        march(**kw, wrap="mirror")
    with pytest.raises(ValueError, match=fmt):
        march(**{**kw, "pool": _pooled_inputs(other)[0]["pool"]})
    with pytest.raises(ValueError, match="hit"):
        march(**{**kw, "hit": kw["hit"].bool()})
    with pytest.raises(ValueError, match="max_samples"):
        march(**kw, max_samples=-1)
    with pytest.raises(ValueError, match="contiguous"):
        march(**{**kw, "entry_uv": kw["entry_uv"].transpose(0, 1)})


@pytest.mark.parametrize("march", [IK.iso_march_pooled_narrow_cuda,
                                   IK.iso_march_pooled_pair16_cuda])
def test_iso_pooled_wrappers_reject_bad_inputs(march):
    fmt = "narrow" if "narrow" in march.__name__ else "pair16"
    kw, plan = _pooled_inputs(fmt)
    with pytest.raises(ValueError, match="clamp-only"):
        march(**kw, iso=0.5, wrap="repeat")
    with pytest.raises(ValueError, match="iso"):
        march(**kw, iso=float("nan"))
    with pytest.raises(ValueError, match="slab_map"):
        march(**{**kw, "slab_map": kw["slab_map"].long()}, iso=0.5)
    found, t_hit = march(**kw, iso=0.5)
    shade = dict(pool=kw["pool"], slab_map=kw["slab_map"], entry_uv=kw["entry_uv"],
                 dir_step=kw["dir_step"], direction=plan.direction, found=found, t_hit=t_hit)
    with pytest.raises(ValueError, match="clamp-only"):
        IK.iso_shade_pooled_cuda(**shade, iso=0.5, wrap="repeat")
    with pytest.raises(ValueError, match="found"):
        IK.iso_shade_pooled_cuda(**{**shade, "found": found.to(torch.uint8)}, iso=0.5)
    with pytest.raises(ValueError, match="t_hit"):
        IK.iso_shade_pooled_cuda(**{**shade, "t_hit": t_hit.long()}, iso=0.5)


def test_render_pooled_rejects_other_volume_and_repeat():
    vol, rays = _scene("oblique")
    Z, Y, X = vol.shape
    pool, smap = RK.build_slab_pool(vol)
    small, small_map = RK.build_slab_pool(vol[:8])
    cplan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    iplan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    with pytest.raises(ValueError, match="the plan's"):
        cplan.render_pooled(small, small_map)
    with pytest.raises(ValueError, match="the plan's"):
        iplan.render_pooled(small, small_map, 0.5)
    for plan_cls in (RK.CompositingPlan, IK.IsosurfacePlan):
        plan = plan_cls(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), wrap="repeat")
        with pytest.raises(ValueError, match="clamp-only"):
            if plan_cls is RK.CompositingPlan:
                plan.render_pooled(pool, smap)
            else:
                plan.render_pooled(pool, smap, 0.5)


@pytest.mark.parametrize("fmt", sorted(POOLS))
def test_slot_zero_reads_are_exact(fmt):
    """Slabs whose z-blocks are empty map to the all-zero slot 0, and the
    pooled renders stay equal to the dense ones through them."""
    u8 = np.zeros((32, 16, 32), np.uint8)
    u8[18:22, 3:13, 5:27] = turbulence_volume((4, 10, 22), seed=8)
    vol = as_normalized_volume(u8, device="cpu")
    pool, smap = POOLS[fmt](vol)
    assert smap.tolist() == [[0, 1, 2, 0]] and not pool[0].any()
    rays = generate_rays(Camera(width=40, height=24, **CAMERAS["oblique"]), device="cpu")
    cplan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (32, 16, 32))
    iplan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (32, 16, 32))
    rgb_p, a_p = cplan.render_pooled(pool, smap)
    rgb_d, a_d = cplan.render(vol)
    assert float(a_d.sum()) > 1 and torch.equal(rgb_p, rgb_d) and torch.equal(a_p, a_d)
    rgb_p, f_p = iplan.render_pooled(pool, smap, 0.3)
    rgb_d, f_d = iplan.render(vol, 0.3)
    assert int(f_d.sum()) > 0 and torch.equal(rgb_p, rgb_d) and torch.equal(f_p, f_d)
