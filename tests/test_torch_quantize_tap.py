"""The 8-bit quantize folded into each tap of B1 and B4.

``csrc/trilinear.cuh::VolumeSampler<float>`` reads the float32 volume and
maps each tap v to ``rintf(fminf(fmaxf(v, 0), 1) * 255) * (1/255)``, in
place of a ``quantize_u8`` pass and a byte tap.  The CPU tests emulate that
formula in numpy float32 and hold it to ``quantize_u8``'s bytes on the
values where a rounding could part them, and hold the entry points that now
take the float32 volume (``CompositingPlan.render``,
``render_tf_grads_kernel``, ``make_render_tf_voxel``) against the JAX
package on a volume with values outside [0, 1], quantized by JAX's own
``pack_pairs``.  The ``cuda``-marked tests hold the fused kernels against
the plain versions and the byte route on the card.

The machine with the card has no JAX, so this file imports JAX only inside
the tests that compare with it; there the card's tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_quantize_tap.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.diff.closed_form import tf_march_steps, tf_scalars
from volumerenderer_tpu_torch.interop import rays_from_numpy, tf_params_from_numpy
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.cuda import tf_kernel as TK
from volumerenderer_tpu_torch.ops.cuda import voxel_grad_kernel as VK
from volumerenderer_tpu_torch.ops.raycast import (apply_reference_transfer, composite_march_steps,
                                                  step_sizes)

VOL_SHAPE = (8, 16, 128)  # (Z, Y, X), the interpret-mode tests' volume
NON_REFERENCE = dict(alpha_scale=0.45, color_gain=0.9, color_bias=0.05,
                     flip_sign=[-0.8, 0.6, 0.3], flip_bias=[0.9, 0.2, 0.4])
F32 = np.float32


def _tap_bytes(v: np.ndarray) -> np.ndarray:
    """The kernel's tap formula before its 1/255 scale, in numpy float32."""
    return np.rint(np.minimum(np.maximum(v, F32(0)), F32(1)) * F32(255))


def _ulps_around(x: np.ndarray, n: int) -> np.ndarray:
    """Every float32 within ``n`` ulps of each value of ``x``."""
    out = [x]
    for direction in (np.inf, -np.inf):
        y = x
        for _ in range(n):
            y = np.nextafter(y, F32(direction))
            out.append(y)
    return np.concatenate(out)


HALF_POINTS = ((np.arange(255, dtype=np.float64) + 0.5) / 255.0).astype(F32)
TAP_CASES = {
    "half_points_4ulp": _ulps_around(HALF_POINTS, 4),
    "byte_values_4ulp": _ulps_around((np.arange(256, dtype=np.float64) / 255.0).astype(F32), 4),
    "negatives": -np.geomspace(1e-30, 1e30, 301).astype(F32),
    "above_one": np.concatenate([_ulps_around(np.array([1.0], F32), 8),
                                 np.geomspace(1.0 + 1e-6, 1e30, 301).astype(F32)]),
    "signed_zeros": np.array([0.0, -0.0], F32),
    "subnormals": np.concatenate([np.array([np.finfo(F32).smallest_subnormal,
                                            np.finfo(F32).smallest_normal], F32),
                                  (np.arange(1, 64, dtype=F32)
                                   * np.finfo(F32).smallest_subnormal)]),
    "infinities": np.array([np.inf, -np.inf, np.finfo(F32).max, -np.finfo(F32).max], F32),
}
TAP_CASES["subnormals"] = np.concatenate([TAP_CASES["subnormals"], -TAP_CASES["subnormals"]])


@pytest.mark.parametrize("case", sorted(TAP_CASES))
def test_tap_formula_equals_quantize_u8(case):
    """The tap formula gives ``quantize_u8``'s byte, and after the 1/255
    scale the float the byte tap reads (``as_normalized_volume``)."""
    v = TAP_CASES[case]
    with np.errstate(over="ignore", invalid="ignore"):
        taps = _tap_bytes(v)
    q = RK.quantize_u8(torch.from_numpy(v.copy()))
    assert np.array_equal(taps, q.numpy().astype(F32)), case
    assert F32(1.0) / F32(255.0) == F32(1.0 / 255.0)  # the kernel's 1.0f / 255.0f
    scaled = taps * (F32(1.0) / F32(255.0))
    assert np.array_equal(scaled.view(np.int32) & 0x7FFFFFFF,  # -0 and +0 read alike
                          as_normalized_volume(q).numpy().view(np.int32))


def _out_of_range_volume() -> np.ndarray:
    """A (8, 16, 128) float32 volume with values below 0, above 1 and at
    (k + 0.5)/255 one ulp either side, among plain values in [0, 1]."""
    rng = np.random.default_rng(11)
    v = rng.random(VOL_SHAPE).astype(F32)
    k = rng.integers(0, 255, VOL_SHAPE)
    half = ((k + 0.5) / 255.0).astype(F32)
    pick = rng.integers(0, 6, VOL_SHAPE)
    v = np.where(pick == 0, -rng.random(VOL_SHAPE).astype(F32), v)
    v = np.where(pick == 1, F32(1) + rng.random(VOL_SHAPE).astype(F32), v)
    v = np.where(pick == 2, np.nextafter(half, F32(-1)), v)
    v = np.where(pick == 3, np.nextafter(half, F32(2)), v)
    return v.astype(F32)


def _jax_bytes(v: np.ndarray) -> np.ndarray:
    """JAX's own 8-bit quantization of ``v``: the high byte of the TPU
    kernel's pair volume (``raycast_kernel.py::pack_pairs``)."""
    from volumerenderer_tpu.ops.pallas import raycast_kernel as JK

    return (np.asarray(JK.pack_pairs(v)) // 256).astype(np.uint8)


def _jax_rays(width=64, height=32):
    import volumerenderer_tpu as J

    rays = J.generate_rays(J.Camera(width=width, height=height))
    return tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


def _plan(rays_np, max_samples=24):
    rays = rays_from_numpy(*rays_np, device="cpu")
    Z, Y, X = VOL_SHAPE
    return RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z),
                              max_samples=max_samples)


def _jax_params():
    import jax.numpy as jnp
    from volumerenderer_tpu.diff.transfer import TFParams as JTFParams

    return JTFParams(**{k: jnp.asarray(v, jnp.float32) for k, v in NON_REFERENCE.items()})


def test_jax_quantizes_as_quantize_u8():
    v = _out_of_range_volume()
    assert np.array_equal(_jax_bytes(v), RK.quantize_u8(torch.from_numpy(v)).numpy())


def test_plan_render_out_of_range_matches_jax_pallas_plan():
    """``CompositingPlan.render`` of the float32 volume vs the JAX plan's
    Pallas kernel in interpret mode, which quantizes the volume inside its
    launch: within test_pallas_interpret.py's 1e-5."""
    from jax.experimental.pallas import tpu as pltpu

    from volumerenderer_tpu.ops.pallas import raycast_kernel as JK
    from conftest import EAGER_INTERPRET

    v = _out_of_range_volume()
    rays_np = _jax_rays()
    Z, Y, X = VOL_SHAPE
    with pltpu.force_tpu_interpret_mode(EAGER_INTERPRET):
        plan_j = JK.CompositingPlan(*rays_np, (X, Y, Z), max_samples=24)
        assert plan_j.use_kernel
        rgb_j, a_j = plan_j.render(v)
    rgb_t, a_t = _plan(rays_np).render(torch.from_numpy(v))
    assert float(a_t.max()) > 0.9
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)


def test_render_tf_grads_kernel_out_of_range_matches_jax_render_tf():
    """``render_tf_grads_kernel`` of the float32 volume vs JAX ``render_tf``
    on JAX's quantization of it: rgb and alpha within 1e-5."""
    import volumerenderer_tpu as J
    from volumerenderer_tpu.diff.transfer import render_tf as render_tf_jax

    v = _out_of_range_volume()
    e, d, h = rays_np = _jax_rays()
    rgb_j, a_j = render_tf_jax(_jax_params(), J.as_normalized_volume(_jax_bytes(v)), e, d, h,
                               max_samples=24)
    params = tf_params_from_numpy(device="cpu", **NON_REFERENCE)
    rgb, a, partials = TK.render_tf_grads_kernel(params, torch.from_numpy(v), _plan(rays_np))
    assert float(a.max()) > 0.9 and len(partials) == 7
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-5, rtol=0)


def test_render_tf_voxel_out_of_range_matches_jax_o1():
    """``make_render_tf_voxel`` on the float32 volume vs JAX ``render_tf_o1``
    on JAX's quantization of it, general cotangents: the outputs within
    1e-5, g_vol within 2e-4 * max(1, max |g|) and the params within rtol 2e-4
    (test_pallas_interpret.py:417-427).  The gradient passes straight
    through the quantization, out-of-range voxels included, as in JAX."""
    import jax
    import jax.numpy as jnp

    import volumerenderer_tpu as J
    from volumerenderer_tpu.diff.vjp import render_tf_o1 as render_tf_o1_jax

    v = _out_of_range_volume()
    e, d, h = rays_np = _jax_rays()
    rng = np.random.default_rng(5)
    w_rgb = rng.standard_normal((32, 64, 3)).astype(F32)
    w_a = rng.standard_normal((32, 64)).astype(F32)

    def loss_ref(p, vol):
        rgb, a = render_tf_o1_jax(p, vol, e, d, h, 24, True)
        return jnp.sum(rgb * w_rgb) + jnp.sum(a * w_a)

    vol_j = J.as_normalized_volume(_jax_bytes(v))
    gp_ref, gv_ref = jax.grad(loss_ref, argnums=(0, 1))(_jax_params(), vol_j)
    rgb_ref, a_ref = render_tf_o1_jax(_jax_params(), vol_j, e, d, h, 24, True)

    f = VK.make_render_tf_voxel(_plan(rays_np))
    params = TFParams(*(t.requires_grad_(True)
                        for t in tf_params_from_numpy(device="cpu", **NON_REFERENCE)))
    vt = torch.from_numpy(v).requires_grad_(True)
    rgb, a = f(params, vt)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(a_ref), atol=1e-5, rtol=0)
    loss = torch.sum(rgb * torch.tensor(w_rgb)) + torch.sum(a * torch.tensor(w_a))
    *gp, gv = torch.autograd.grad(loss, [*params, vt])
    gv_ref = np.asarray(gv_ref)
    assert gv.shape == vt.shape and np.abs(gv_ref).max() > 0.5
    np.testing.assert_allclose(gv.numpy(), gv_ref, rtol=0,
                               atol=2e-4 * max(1.0, np.abs(gv_ref).max()))
    for name, g_t, g_r in zip(TFParams._fields, gp, gp_ref):
        g_r = np.asarray(g_r)
        np.testing.assert_allclose(g_t.numpy(), g_r, rtol=2e-4,
                                   atol=2e-4 * max(1.0, np.abs(g_r).max()), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.int32])
def test_render_refuses_other_dtypes(dtype):
    rays = generate_rays(Camera(width=16, height=8), device="cpu")
    Z, Y, X = VOL_SHAPE
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    vol = torch.zeros(VOL_SHAPE, dtype=dtype)
    with pytest.raises(ValueError, match="float32 in \\[0, 1\\] or uint8"):
        plan.render(vol)
    with pytest.raises(ValueError, match="float32 in \\[0, 1\\] or uint8"):
        TK.render_tf_grads_kernel(TFParams.reference("cpu"), vol, plan)


@pytest.mark.parametrize("dtype,suffix", [(torch.uint8, ""), (torch.float32, "_f32"),
                                          (torch.float64, None), (torch.float16, None),
                                          (torch.int32, None)])
def test_dense_entry_of_each_volume_dtype(dtype, suffix):
    """The one choice of a dense march's C entry: a uint8 volume's bytes,
    a float32 volume's values quantized tap by tap; other dtypes raise.
    ``count_launch`` counts the float32 route apart."""
    from volumerenderer_tpu_torch.ops.cuda import _launch

    vol = torch.zeros(VOL_SHAPE, dtype=dtype)
    if suffix is None:
        with pytest.raises(ValueError, match="float32 in \\[0, 1\\] or uint8"):
            _launch.dense_entry("composite_march", vol)
        return
    assert _launch.dense_entry("composite_march", vol) == "composite_march" + suffix

    def wrapper():
        pass

    wrapper.launches = wrapper.f32_launches = 0
    _launch.count_launch(wrapper, vol)
    assert (wrapper.launches, wrapper.f32_launches) == (1, int(dtype == torch.float32))


def test_render_of_bytes_equals_render_of_floats():
    """A uint8 volume takes the byte route; its render equals the float32
    route's on ``as_normalized_volume`` of the same bytes, bit for bit."""
    rays = generate_rays(Camera(width=32, height=16), device="cpu")
    u8 = torch.from_numpy(turbulence_volume(VOL_SHAPE, seed=3))
    Z, Y, X = VOL_SHAPE
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), 24)
    for a, b in zip(plan.render(u8), plan.render(as_normalized_volume(u8))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_render_of_a_sliced_volume_equals_its_copy(request, device):
    """A float32 volume that is a view (a slice of a larger volume, not
    contiguous) renders through ``CompositingPlan.render``,
    ``render_tf_grads_kernel`` and ``make_render_tf_voxel`` as its
    contiguous copy does, the volume's gradient included."""
    if device == "cuda":
        device = request.getfixturevalue("cuda_device")
    Z, Y, X = VOL_SHAPE
    big = as_normalized_volume(turbulence_volume((Z, Y, 2 * X), seed=4), device=device)
    view, copy = big[:, :, :X], big[:, :, :X].contiguous()
    assert not view.is_contiguous()
    rays = generate_rays(Camera(width=32, height=16), device=device)
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), 24)
    params = tf_params_from_numpy(device=device, **NON_REFERENCE)
    for a, b in zip(plan.render(view), plan.render(copy)):
        assert torch.equal(a, b)
    got, want = (TK.render_tf_grads_kernel(params, v, plan) for v in (view, copy))
    assert all(torch.equal(a, b) for a, b in zip((*got[:2], *got[2]), (*want[:2], *want[2])))
    f = VK.make_render_tf_voxel(plan)
    leaf_big, leaf_copy = big.clone().requires_grad_(True), copy.clone().requires_grad_(True)
    (g_view,) = torch.autograd.grad(f(params, leaf_big[:, :, :X])[0].sum(), [leaf_big])
    (g_copy,) = torch.autograd.grad(f(params, leaf_copy)[0].sum(), [leaf_copy])
    assert bool(g_copy.any()) and not bool(g_view[:, :, X:].any())
    if g_copy.device.type == "cpu":
        assert torch.equal(g_view[:, :, :X], g_copy)
    else:  # B5's atomics add in no fixed order: its bar, 2e-5 of max |g|
        scale = float(g_copy.abs().max())
        assert float((g_view[:, :, :X] - g_copy).abs().max()) <= 2e-5 * scale


def _saved_dtypes(fn):
    """The dtypes and shapes of every tensor autograd saves while ``fn``
    runs, and ``fn``'s result."""
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return saved, out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_tf_only_step_saves_no_byte_volume(request, device):
    """A TF fit step (``make_render_tf_kernel``) keeps neither a byte copy
    of the volume nor the volume for its backward; with the volume's
    gradient asked for (``make_render_tf_voxel``) it keeps the float32
    volume, and quantizes it only in the backward, for B5."""
    if device == "cuda":
        device = request.getfixturevalue("cuda_device")
    rays = generate_rays(Camera(width=32, height=16), device=device)
    vol = as_normalized_volume(turbulence_volume(VOL_SHAPE, seed=3), device=device)
    Z, Y, X = VOL_SHAPE
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), 24)
    target = torch.full((16, 32, 3), 0.5, device=device)
    saved, (new, loss) = _saved_dtypes(lambda: TK.tf_fit_step_fast(
        TK.make_render_tf_kernel(plan), TFParams.reference(device), vol, target))
    assert torch.isfinite(loss)
    assert all(dt != torch.uint8 and shape != VOL_SHAPE for dt, shape in saved), saved
    leaves = TFParams(*(p.requires_grad_() for p in TFParams.reference(device)))
    vt = vol.clone().requires_grad_(True)
    saved, (rgb, _) = _saved_dtypes(lambda: VK.make_render_tf_voxel(plan)(leaves, vt))
    assert (torch.float32, VOL_SHAPE) in saved
    assert all(dt != torch.uint8 for dt, _ in saved), saved
    (g_vol,) = torch.autograd.grad(torch.mean((rgb - target) ** 2), [vt])
    assert g_vol.shape == VOL_SHAPE and bool(g_vol.any())


def _adversarial(device, shape=(64, 48, 96)):
    """The turbulence, with values below 0 and above 1 and at (k + 0.5)/255
    one ulp either side mixed in (seeded)."""
    rng = np.random.default_rng(13)
    v = turbulence_volume(shape, seed=1).astype(F32) / F32(255)
    half = ((rng.integers(0, 255, shape) + 0.5) / 255.0).astype(F32)
    pick = rng.integers(0, 8, shape)
    v = np.where(pick == 0, -rng.random(shape).astype(F32), v)
    v = np.where(pick == 1, F32(1) + rng.random(shape).astype(F32), v)
    v = np.where(pick == 2, np.nextafter(half, F32(-1)), v)
    v = np.where(pick == 3, np.nextafter(half, F32(2)), v)
    v = np.where(pick == 4, half, v)
    return torch.from_numpy(v.astype(F32)).to(device)


def _card_scene(device, volume):
    vol = (_adversarial(device) if volume == "adversarial" else
           as_normalized_volume(turbulence_volume((64, 48, 96), seed=1), device=device))
    rays = generate_rays(Camera(width=96, height=64, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device=device)
    Z, Y, X = vol.shape
    dir_step = (rays.direction * step_sizes((X, Y, Z), device)).contiguous()
    return vol, rays, dir_step, rays.hit.to(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("volume", ["turbulence", "adversarial"])
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_fused_b1_equals_plain_on_cuda(cuda_device, wrap, volume):
    """The fused B1 (float32 taps quantized as read, the transfer in its
    epilogue) vs the plain march on ``quantize_u8`` of the volume and
    ``apply_reference_transfer``, and vs the byte route: bit for bit."""
    vol, rays, dir_step, hit = _card_scene(cuda_device, volume)
    march = RK.composite_march_cuda
    before = (march.launches, march.f32_launches)
    rgb_k, a_k = march(vol, rays.entry_uv, dir_step, hit, wrap=wrap)
    torch.cuda.synchronize()
    assert (march.launches, march.f32_launches) == (before[0] + 1, before[1] + 1)
    vol_u8 = RK.quantize_u8(vol)
    c_p, a_p = composite_march_steps(as_normalized_volume(vol_u8), rays.entry_uv, dir_step,
                                     rays.hit, wrap=wrap)
    assert float(a_p.max()) > 0.5
    assert torch.equal(rgb_k, apply_reference_transfer(c_p, a_p)) and torch.equal(a_k, a_p)
    rgb_b, a_b = march(vol_u8, rays.entry_uv, dir_step, hit, wrap=wrap)
    assert march.f32_launches == before[1] + 1
    assert torch.equal(rgb_k, rgb_b) and torch.equal(a_k, a_b)


@pytest.mark.cuda
@pytest.mark.parametrize("volume", ["turbulence", "adversarial"])
@pytest.mark.parametrize("kind", ["reference", "non_reference"])
def test_fused_b4_equals_byte_route_on_cuda(cuda_device, kind, volume):
    """The fused B4 vs B4 on ``quantize_u8`` of the volume: all seven planes
    bit for bit; and vs the plain version within the kernel's bars."""
    vol, rays, dir_step, hit = _card_scene(cuda_device, volume)
    params = (TFParams.reference(cuda_device) if kind == "reference"
              else tf_params_from_numpy(device=cuda_device, **NON_REFERENCE))
    tf = tf_scalars(params)
    before = TK.tf_march_cuda.f32_launches
    got = TK.tf_march_cuda(vol, rays.entry_uv, dir_step, hit, tf)
    torch.cuda.synchronize()
    assert TK.tf_march_cuda.f32_launches == before + 1
    vol_u8 = RK.quantize_u8(vol)
    byte = TK.tf_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, tf)
    assert all(torch.equal(a, b) for a, b in zip(got, byte))
    ref = tf_march_steps(as_normalized_volume(vol_u8), rays.entry_uv, dir_step, rays.hit, tf)
    assert float(ref[1].max()) > 0.5
    for k, p in zip(got, ref):
        assert float(((k - p).abs() / torch.clamp(p.abs(), min=1.0)).max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["narrow", "pair16"])
def test_pooled_epilogue_equals_transfer_on_cuda(cuda_device, fmt):
    """B6 and B7 with the transfer in their epilogue vs
    ``apply_reference_transfer`` of the plain march's color on the bytes the
    pool was built from, and vs the dense fused render of the float32
    volume: bit for bit."""
    vol, rays, dir_step, hit = _card_scene(cuda_device, "turbulence")
    build = {"narrow": RK.build_slab_pool_narrow, "pair16": RK.build_slab_pool}[fmt]
    march = {"narrow": RK.composite_march_pooled_narrow_cuda,
             "pair16": RK.composite_march_pooled_pair16_cuda}[fmt]
    pool, smap = build(RK.quantize_u8(vol))
    before = march.launches
    rgb_k, a_k = march(pool, smap, rays.entry_uv, dir_step, hit)
    torch.cuda.synchronize()
    assert march.launches == before + 1
    c, a = composite_march_steps(as_normalized_volume(RK.quantize_u8(vol)), rays.entry_uv,
                                 dir_step, rays.hit)
    assert float(a.max()) > 0.5
    assert torch.equal(rgb_k, apply_reference_transfer(c, a)) and torch.equal(a_k, a)
    Z, Y, X = vol.shape
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    rgb_d, a_d = plan.render(vol)
    rgb_p, a_p = plan.render_pooled(pool, smap)
    assert torch.equal(rgb_p, rgb_d) and torch.equal(a_p, a_d) and torch.equal(rgb_p, rgb_k)
