"""The port's sharded layouts on a mesh of CPU devices.

The plain z-sharded and brick-sharded renders and the row-sharded TF render
and fit step are held against the JAX package's on conftest's 8-device CPU
mesh (atol 1e-5: both use analytic positions, and their sums run in the same
order).  The kernel paths run their wrappers' plain versions here (the
tensors lie on the CPU): the volume-sharded ones are held against the plain
renders (atol 1e-5: positions by repeated addition against analytic ones,
over 24 steps as tests/test_kernel_sharded.py holds them), against each
other, and within the early-out envelope of the dense render
(``docs/PARITY.md`` deviation 6); the row-sharded ones against the
single-device plan, bit for bit, and the single-device fit steps.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.interop import rays_from_numpy, tf_params_from_numpy
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.models import plan_compositing
from volumerenderer_tpu_torch.ops.cuda.tf_kernel import make_render_tf_kernel, tf_fit_step_fast
from volumerenderer_tpu_torch.ops.cuda.voxel_grad_kernel import make_render_tf_voxel
from volumerenderer_tpu_torch.ops.raycast import ALPHA_SCALE, EARLY_OUT_ALPHA
from volumerenderer_tpu_torch.parallel import bricks, context, kernel_sharded as KS, sharding

CPU4 = [torch.device("cpu")] * 4
SEG_VOL_SHAPE = (32, 32, 128)  # (Z, Y, X) of tests/test_kernel_sharded.py


def _small_volume_u8():
    return turbulence_volume((16, 16, 16), seed=6)


def _jax_rays(cam_kwargs):
    import volumerenderer_tpu as J

    rays = J.generate_rays(J.Camera(**cam_kwargs))
    return rays, tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


OBLIQUE = dict(position=(0.5, 0.4, -0.6), front=(-0.55, -0.45, 0.7), width=16, height=16)
DESCENDING = dict(position=(0.6, 0.5, 0.75), front=(-0.5, -0.45, -0.7), width=16, height=16)


@pytest.mark.parametrize("n,cam", [(2, "default"), (4, "descending")])
def test_render_zsharded_matches_jax(n, cam):
    import volumerenderer_tpu as J
    from volumerenderer_tpu.parallel import context as JC

    cam_kwargs = DESCENDING if cam == "descending" else dict(width=24, height=16)
    vol_u8 = _small_volume_u8()
    rays_j, arrays = _jax_rays(cam_kwargs)
    vol_j = J.as_normalized_volume(vol_u8) * 0.25
    rgb_j, a_j = JC.render_zsharded(JC.make_z_mesh(n), vol_j, rays_j.entry_uv,
                                    rays_j.direction, rays_j.hit, max_samples=64)
    rays = rays_from_numpy(*arrays, device="cpu")
    rgb, a = context.render_zsharded(context.make_z_mesh(n, devices=CPU4),
                                     as_normalized_volume(vol_u8, device="cpu") * 0.25,
                                     rays.entry_uv, rays.direction, rays.hit, max_samples=64)
    assert float(a.max()) > 0.2
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 2, 1), (1, 2, 2), (2, 1, 2)])
def test_render_bricksharded_matches_jax(shape):
    import volumerenderer_tpu as J
    from volumerenderer_tpu.parallel import bricks as JB

    vol_u8 = _small_volume_u8()
    rays_j, arrays = _jax_rays(OBLIQUE)
    vol_j = J.as_normalized_volume(vol_u8) * 0.25
    mesh_j = JB.make_brick_mesh(shape)
    rgb_j, a_j = JB.render_bricksharded(mesh_j, JB.shard_volume(mesh_j, vol_j),
                                        rays_j.entry_uv, rays_j.direction, rays_j.hit,
                                        max_samples=48)
    rays = rays_from_numpy(*arrays, device="cpu")
    mesh = bricks.make_brick_mesh(shape, devices=CPU4)
    sv = bricks.shard_volume(mesh, as_normalized_volume(vol_u8, device="cpu") * 0.25)
    rgb, a = bricks.render_bricksharded(mesh, sv, rays.entry_uv, rays.direction, rays.hit,
                                        max_samples=48)
    assert float(a.max()) > 0.2
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-5, rtol=0)


def test_composite_segments_match_jax():
    import jax.numpy as jnp
    from volumerenderer_tpu.parallel import bricks as JB, context as JC

    rng = np.random.default_rng(2)
    C = rng.random((4, 5, 7)).astype(np.float32)
    T = rng.uniform(0.2, 1.0, (4, 5, 7)).astype(np.float32)
    asc = rng.random((5, 7)) > 0.5
    t_first = rng.permuted(np.tile(np.arange(4, dtype=np.float32)[:, None, None] * 5.0,
                                   (1, 5, 7)), axis=0)
    t_first[1, :, :3] = bricks.BIG_T
    got = context.composite_segments(torch.from_numpy(C), torch.from_numpy(T),
                                     torch.from_numpy(asc))
    want = JC.composite_segments(jnp.asarray(C), jnp.asarray(T), jnp.asarray(asc))
    got_o = bricks.composite_segments_ordered(torch.from_numpy(C), torch.from_numpy(T),
                                              torch.from_numpy(t_first))
    want_o = JB.composite_segments_ordered(jnp.asarray(C), jnp.asarray(T),
                                           jnp.asarray(t_first))
    for g, w in [*zip(got, want), *zip(got_o, want_o)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_shard_volume_and_halos():
    """Each brick holds its part of the volume, and its halo the next
    bricks' first planes, corners included; the last brick of an axis
    repeats its own last plane."""
    vol = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    mesh = bricks.make_brick_mesh((2, 3, 2), devices=[torch.device("cpu")] * 12)
    sv = bricks.shard_volume(mesh, vol)
    assert sv.shape == (8, 6, 4) and sv.brick_shape == (4, 2, 2)
    ext = bricks.extend_halos(sv.bricks)
    for iz, iy, ix in np.ndindex(2, 3, 2):
        zi = np.minimum(np.arange(iz * 4, iz * 4 + 5), 7)
        yi = np.minimum(np.arange(iy * 2, iy * 2 + 3), 5)
        xi = np.minimum(np.arange(ix * 2, ix * 2 + 3), 3)
        assert torch.equal(sv.bricks[iz, iy, ix], vol[iz * 4:iz * 4 + 4, iy * 2:iy * 2 + 2,
                                                      ix * 2:ix * 2 + 2])
        assert torch.equal(ext[iz, iy, ix], vol[zi][:, yi][:, :, xi])
    with pytest.raises(ValueError, match="split"):
        bricks.shard_volume(bricks.make_brick_mesh((3, 1, 1), devices=CPU4), vol)


def test_as_sharded_takes_only_bricks_on_the_meshs_devices():
    """A placed volume is used as it is on a mesh of the same split and
    devices, and refused on another split or where its bricks lie on other
    devices (here ``meta`` ones stand for another mesh's cards)."""
    vol = torch.zeros((8, 8, 8))
    meta = bricks.make_brick_mesh((2, 1, 1), devices=[torch.device("meta")] * 2)
    sv = bricks.shard_volume(meta, vol)
    same = bricks.make_brick_mesh((2, 1, 1), devices=[torch.device("meta")] * 2)
    assert bricks.as_sharded(same, sv) is sv
    with pytest.raises(ValueError, match="mesh's devices"):
        bricks.as_sharded(bricks.make_brick_mesh((2, 1, 1), devices=CPU4), sv)
    with pytest.raises(ValueError, match="split"):
        bricks.as_sharded(bricks.make_brick_mesh((1, 2, 1), devices=CPU4), sv)


def _seg_scene(scale=1.0):
    rng = np.random.default_rng(11)
    vol = as_normalized_volume(np.round(rng.random(SEG_VOL_SHAPE) * 255.0).astype(np.uint8),
                               device="cpu")
    rays = generate_rays(Camera(width=64, height=32), device="cpu")
    Z, Y, X = SEG_VOL_SHAPE
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), 24)
    return vol * scale, rays, plan


def test_volume_sharded_kernel_paths_match_the_plain_renders():
    vol, rays, plan = _seg_scene()
    zmesh = context.make_z_mesh(4, devices=CPU4)
    bmesh = bricks.make_brick_mesh((2, 2, 1), devices=CPU4)
    rgb_z, a_z = KS.render_zsharded_kernel(zmesh, plan, vol)
    rgb_b, a_b = KS.render_bricksharded_kernel(bmesh, plan, bricks.shard_volume(bmesh, vol))
    rgb_zp, a_zp = context.render_zsharded(zmesh, vol, rays.entry_uv, rays.direction, rays.hit,
                                           max_samples=24)
    rgb_bp, a_bp = bricks.render_bricksharded(bmesh, vol, rays.entry_uv, rays.direction,
                                              rays.hit, max_samples=24)
    assert float(a_z.max()) > 0.5
    for got, want in [(rgb_z, rgb_zp), (a_z, a_zp), (rgb_b, rgb_bp), (a_b, a_bp),
                      (rgb_b, rgb_z), (a_b, a_z)]:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_volume_sharded_kernel_paths_within_the_early_out_envelope():
    """Against the dense render with its a > 0.99 early-out, on a dense
    volume over 64 steps where it fires: the sharded frames omit only what
    follows it (tests/test_context_parallel.py's bound)."""
    tau0 = 1.0 - EARLY_OUT_ALPHA
    vol = as_normalized_volume(_small_volume_u8(), device="cpu")
    rays = generate_rays(Camera(width=24, height=16), device="cpu")
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (16, 16, 16), 64)
    rgb_d, a_d = plan.render(vol)
    assert float(a_d.max()) > EARLY_OUT_ALPHA
    frames = [KS.render_zsharded_kernel(context.make_z_mesh(n, devices=CPU4), plan, vol)
              for n in (2, 4)]
    frames.append(KS.render_bricksharded_kernel(
        bricks.make_brick_mesh((2, 2, 1), devices=CPU4), plan, vol))
    for rgb, a in frames:
        assert float((rgb - rgb_d).abs().max()) <= tau0 / ALPHA_SCALE + 1e-5
        assert float((a - a_d).abs().max()) <= tau0 + 1e-5


def test_seg_plan_ok_and_bad_layouts():
    vol, _, plan = _seg_scene()
    assert KS.seg_plan_ok(plan, 4) and KS.seg_plan_ok(plan, 2, 2)
    assert not KS.seg_plan_ok(plan, 3) and not KS.seg_plan_ok(plan, 2, 2, 2)
    with pytest.raises(ValueError, match="x whole"):
        KS.render_bricksharded_kernel(bricks.make_brick_mesh((1, 2, 2), devices=CPU4), plan, vol)
    with pytest.raises(ValueError, match="1-D mesh"):
        KS.render_zsharded_kernel(bricks.make_brick_mesh((4, 1, 1), devices=CPU4), plan, vol)


def _fit_params():
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return TFParams(f32(0.45), f32(0.9), f32(0.05), f32([-0.8, 0.6, 0.3]), f32([0.9, 0.2, 0.4]))


def _target(shape, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).random(shape + (3,)).astype(np.float32))


def test_tf_fit_step_bricksharded_matches_single_device():
    """On the x0.25 volume the single-device early-out never fires, so the
    composed TF sums are the unsharded ones (tests/test_kernel_sharded.py)."""
    vol, _, plan = _seg_scene(0.25)
    target = _target(plan.shape)
    params = _fit_params()
    mesh = bricks.make_brick_mesh((2, 2, 1), devices=CPU4)
    new_s, loss_s = KS.tf_fit_step_bricksharded(mesh, plan, params,
                                                bricks.shard_volume(mesh, vol), target, lr=1e-2)
    new_1, loss_1 = tf_fit_step_fast(make_render_tf_kernel(plan), params, vol, target, lr=1e-2)
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-5)
    for name, a, b in zip(TFParams._fields, new_s, new_1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_render_planned_sharded_equals_plan_render(n):
    vol, _, plan = _seg_scene()
    mesh = sharding.DeviceMesh(CPU4[:n], ("rays",))
    assert KS.plan_shardable(plan, n) and not KS.plan_shardable(plan, 5)
    got = KS.render_planned_sharded(mesh, plan, vol)
    want = plan.render(vol)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_tf_fit_step_kernel_matches_single_device():
    vol, _, plan = _seg_scene()
    target = _target(plan.shape)
    params = _fit_params()
    mesh = sharding.DeviceMesh(CPU4, ("rays",))
    new_s, loss_s = KS.tf_fit_step_kernel(mesh, plan, params, vol, target, lr=1e-2)
    new_1, loss_1 = tf_fit_step_fast(make_render_tf_kernel(plan), params, vol, target, lr=1e-2)
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-6)
    for name, a, b in zip(TFParams._fields, new_s, new_1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


def test_voxel_fit_step_kernel_matches_single_device():
    vol, _, plan = _seg_scene()
    target = _target(plan.shape)
    params = TFParams.reference(device="cpu")
    mesh = sharding.DeviceMesh(CPU4, ("rays",))
    new_p, new_v, loss_s = KS.voxel_fit_step_kernel(mesh, plan, params, vol, target,
                                                    lr_vol=0.1, lr_tf=1e-2)
    leaves = TFParams(*(p.clone().requires_grad_(True) for p in params))
    vt = vol.clone().requires_grad_(True)
    rgb, _ = make_render_tf_voxel(plan)(leaves, vt)
    loss_1 = torch.mean((rgb - target) ** 2)
    *gp, gv = torch.autograd.grad(loss_1, [*leaves, vt])
    ref_v = torch.clamp(vol - 0.1 * gv, 0.0, 1.0)
    np.testing.assert_allclose(float(loss_s), float(loss_1.detach()), rtol=1e-6)
    assert float((new_v - vol).abs().max()) > 0
    np.testing.assert_allclose(new_v.numpy(), ref_v.numpy(), rtol=1e-4, atol=1e-6)
    for name, a, p, g in zip(TFParams._fields, new_p, params, gp):
        np.testing.assert_allclose(a.numpy(), (p - 1e-2 * g).numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_render_tf_sharded_and_tf_fit_step_match_jax():
    import jax.numpy as jnp

    import volumerenderer_tpu as J
    from volumerenderer_tpu.diff.transfer import TFParams as JTFParams
    from volumerenderer_tpu.parallel import sharding as JS

    vol_u8 = _small_volume_u8()
    rays_j, arrays = _jax_rays(dict(width=16, height=8))
    vol_j = J.as_normalized_volume(vol_u8)
    p_j = JTFParams(alpha_scale=jnp.float32(0.45), color_gain=jnp.float32(0.9),
                    color_bias=jnp.float32(0.05),
                    flip_sign=jnp.array([-0.8, 0.6, 0.3], jnp.float32),
                    flip_bias=jnp.array([0.9, 0.2, 0.4], jnp.float32))
    params = tf_params_from_numpy(device="cpu", **{k: np.asarray(v)
                                                   for k, v in p_j._asdict().items()})
    rays = rays_from_numpy(*arrays, device="cpu")
    vol = as_normalized_volume(vol_u8, device="cpu")

    rgb_j, a_j = JS.render_tf_sharded(JS.make_mesh(4), p_j, vol_j, rays_j.entry_uv,
                                      rays_j.direction, rays_j.hit, max_samples=32)
    rgb, a = sharding.render_tf_sharded(sharding.make_mesh(devices=CPU4), params, vol,
                                        rays.entry_uv, rays.direction, rays.hit, max_samples=32)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-5, rtol=0)

    # a batch of two views (the second mirrored) over dp=2, rows over 2
    stack = lambda x: np.stack([x, x[:, ::-1]])  # noqa: E731
    batch = [stack(x) for x in arrays]
    target = np.random.default_rng(1).random(batch[2].shape + (3,)).astype(np.float32)
    new_j, loss_j = JS.tf_fit_step(JS.make_mesh(4, dp=2), p_j, vol_j,
                                   *(jnp.asarray(x) for x in batch), jnp.asarray(target),
                                   lr=1e-2, max_samples=32)
    tb = [torch.from_numpy(np.ascontiguousarray(x)) for x in batch]
    new, loss = sharding.tf_fit_step(sharding.make_mesh(devices=CPU4, dp=2), params, vol,
                                     tb[0], tb[1], tb[2], torch.from_numpy(target), lr=1e-2,
                                     max_samples=32)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for name, a, b in zip(TFParams._fields, new, new_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
