"""A uint8 volume is its own bytes on every entry point of the port.

The port takes a (Z, Y, X) uint8 volume beside the float32 one: its bytes
are the 8-bit grid the marches sample, so ``render(u8)`` must equal
``render(u8 / 255)``.  ``quantize_u8`` once mapped every nonzero byte to
255 (``round(clamp(v, 0, 1) * 255)`` of the byte itself), and the entry
points that quantized a volume unconditionally rendered a binarized
volume.  Each test here gives an entry point a 32^3 byte volume and its
float32 ``u8 / 255`` (``as_normalized_volume``, the port's normalization)
on 32^2 rays (CPU tensors: the plain versions, the path the wrappers take
there) and requires the same output; the sharded paths run on a mesh of
two CPU devices.  A float16 volume raises.
"""
import pytest
import torch

from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.cuda.tf_kernel import make_render_tf_kernel, tf_fit_step_fast
from volumerenderer_tpu_torch.ops.cuda.voxel_grad_kernel import (make_render_tf_voxel,
                                                                 voxel_grad_kernel)
from volumerenderer_tpu_torch.parallel import kernel_sharded as KS
from volumerenderer_tpu_torch.parallel import make_brick_mesh, make_mesh, make_z_mesh

SHAPE = (32, 32, 32)
CPU2 = [torch.device("cpu")] * 2


def _scene(max_samples=48):
    u8 = torch.from_numpy(turbulence_volume(SHAPE, seed=11))
    rays = generate_rays(Camera(width=32, height=32, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device="cpu")
    Z, Y, X = SHAPE
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), max_samples)
    return u8, as_normalized_volume(u8), rays, plan


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))


def test_quantize_u8_returns_bytes_as_they_are():
    u8, vol, _, _ = _scene()
    assert RK.quantize_u8(u8) is u8
    assert torch.equal(RK.quantize_u8(vol), u8)
    assert int(u8.max()) > 1  # a binarized volume would differ


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_quantize_u8_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="float32 in \\[0, 1\\] or uint8"):
        RK.quantize_u8(torch.zeros(SHAPE, dtype=dtype))


def test_compositing_plan_render():
    u8, vol, _, plan = _scene()
    assert _equal(plan.render(u8), plan.render(vol))


@pytest.mark.parametrize("entry", ["plan", "render_isosurface_kernel"])
def test_isosurface_render(entry):
    u8, vol, rays, plan = _scene()
    iso = IK.volume_median(vol)
    if entry == "plan":
        iplan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, plan.dims,
                                  plan.max_samples)
        got, want = iplan.render(u8, iso), iplan.render(vol, iso)
    else:
        got, want = (IK.render_isosurface_kernel(v, rays.entry_uv, rays.direction, rays.hit, iso,
                                                 plan.max_samples) for v in (u8, vol))
    rgb, found = got
    assert int(want[1].sum()) > 50
    assert torch.equal(found, want[1]) and torch.equal(rgb, want[0])


def test_float16_volume_raises_on_the_isosurface_render():
    u8, vol, rays, plan = _scene()
    iplan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, plan.dims)
    with pytest.raises(ValueError, match="float32 in \\[0, 1\\] or uint8"):
        iplan.render(vol.half(), 0.5)
    with pytest.raises(ValueError, match="float32 in \\[0, 1\\] or uint8"):
        plan.render(vol.half())


def test_tf_and_voxel_fit_steps():
    u8, vol, _, plan = _scene()
    params = TFParams.reference("cpu")
    target = torch.full(plan.shape + (3,), 0.5)
    f = make_render_tf_kernel(plan)
    assert _equal(tf_fit_step_fast(f, params, u8, target),
                  tf_fit_step_fast(f, params, vol, target))
    fv = make_render_tf_voxel(plan)
    outs = []
    for v in (u8, vol):
        leaves = TFParams(*(p.detach().requires_grad_(True) for p in params))
        rgb, alpha = fv(leaves, v)
        loss = torch.mean((rgb - target) ** 2)
        outs.append((rgb, alpha, torch.autograd.grad(loss, leaves)))
    assert _equal(outs[0], outs[1])
    # the voxel cotangent of the same frame: B5's plain version on the bytes
    from volumerenderer_tpu_torch.ops.cuda.tf_kernel import render_tf_grads_kernel

    rgb, _, partials = render_tf_grads_kernel(params, vol, plan)
    g_rgb = 2.0 * (rgb - target) / rgb.numel()
    g = [voxel_grad_kernel(params, v, plan, g_rgb, None, partials[1], partials[3])
         for v in (u8, vol)]
    assert float(g[1].abs().max()) > 0 and torch.equal(g[0], g[1])


def test_row_sharded_render_and_fit_steps():
    u8, vol, _, plan = _scene()
    mesh = make_mesh(2, devices=CPU2)
    want = plan.render(vol)
    for v in (u8, vol):
        assert _equal(KS.render_planned_sharded(mesh, plan, v), want)
    params = TFParams.reference("cpu")
    target = torch.full(plan.shape + (3,), 0.5)
    assert _equal(KS.tf_fit_step_kernel(mesh, plan, params, u8, target),
                  KS.tf_fit_step_kernel(mesh, plan, params, vol, target))
    got = KS.voxel_fit_step_kernel(mesh, plan, params, u8, target)
    want = KS.voxel_fit_step_kernel(mesh, plan, params, vol, target)
    assert got[1].dtype == torch.float32 and not torch.equal(got[1], vol)
    assert _equal(got, want)


@pytest.mark.parametrize("layout", ["z", "bricks"])
def test_seg_shards_and_sharded_renders(layout):
    u8, vol, _, plan = _scene()
    if layout == "z":
        mesh = make_z_mesh(2, devices=CPU2)
        render = KS.render_zsharded_kernel
    else:
        mesh = make_brick_mesh((1, 2, 1), devices=CPU2)
        render = KS.render_bricksharded_kernel
    for (s_u8, kw_u8), (s_f, kw_f) in zip(KS.seg_shards(mesh, plan, u8),
                                          KS.seg_shards(mesh, plan, vol)):
        assert s_u8.dtype == torch.uint8 and torch.equal(s_u8, s_f) and kw_u8 == kw_f
    assert _equal(render(mesh, plan, u8), render(mesh, plan, vol))
    params = TFParams.reference("cpu")
    target = torch.full(plan.shape + (3,), 0.5)
    if layout == "bricks":
        assert _equal(KS.tf_fit_step_bricksharded(mesh, plan, params, u8, target),
                      KS.tf_fit_step_bricksharded(mesh, plan, params, vol, target))
