"""The port's TF-gradient march: its plain version
(``diff/closed_form.py::tf_march_steps``), its wrapper
(``ops/cuda/tf_kernel.py::tf_march_cuda``) and the fit API around it.

On CPU tensors the wrapper runs the plain version, which is held against the
JAX package's ``render_tf_grads_pallas`` with its Pallas kernel run in
interpret mode, as tests/test_pallas_interpret.py runs it; the differentiable
render is held against JAX ``render_tf`` and ``jax.grad`` within that file's
bars.  The kernel itself runs only where there is a CUDA device: the
``cuda``-marked tests hold it against the plain version and against the
compositing march there.

The machine with the card has no JAX, so this file imports JAX only inside
the tests that compare with it; there the card's tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_tf_kernel.py``.
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
from volumerenderer_tpu_torch.ops.raycast import apply_reference_transfer, step_sizes

VOL_SHAPE = (8, 16, 128)  # (Z, Y, X), the interpret-mode tests' volume
NON_REFERENCE = dict(alpha_scale=0.45, color_gain=0.9, color_bias=0.05,
                     flip_sign=[-0.8, 0.6, 0.3], flip_bias=[0.9, 0.2, 0.4])
NAMES = ("color_T", "alpha_T", "R", "P_total", "QP", "SG", "SB")


def _volume_u8():
    rng = np.random.default_rng(7)
    return np.round(rng.random(VOL_SHAPE) * 255.0).astype(np.uint8)


def _params(device="cpu"):
    """The non-reference params of tests/test_pallas_interpret.py."""
    return tf_params_from_numpy(device=device, **NON_REFERENCE)


def _jax_params():
    import jax.numpy as jnp
    from volumerenderer_tpu.diff.transfer import TFParams as JTFParams

    return JTFParams(**{k: jnp.asarray(v, jnp.float32) for k, v in NON_REFERENCE.items()})


def _jax_rays(width=64, height=32):
    import volumerenderer_tpu as J

    rays = J.generate_rays(J.Camera(width=width, height=height))
    return tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


def _plan(rays_np, max_samples=24, wrap="clamp"):
    rays = rays_from_numpy(*rays_np, device="cpu")
    Z, Y, X = VOL_SHAPE
    return RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z),
                              max_samples=max_samples, wrap=wrap)


@pytest.mark.parametrize("lane_groups", [1, None])
def test_tf_march_steps_matches_jax_pallas_kernel(lane_groups):
    """The seven images of the plain version vs the TPU kernel's, on the JAX
    ``CompositingPlan`` (lane_groups=1 and the auto multi-lane-group plan).
    Bars: color and alpha within test_pallas_interpret.py's 1e-5; the five
    sums within 1e-5 relative to max(1, |TPU value|) per pixel (the TPU
    kernel lerps on the 0..255 scale, the port on [0, 1])."""
    from jax.experimental.pallas import tpu as pltpu

    import volumerenderer_tpu as J
    from volumerenderer_tpu.ops.pallas import raycast_kernel as JRK
    from volumerenderer_tpu.ops.pallas.tf_kernel import render_tf_grads_pallas
    from conftest import EAGER_INTERPRET

    vol_u8 = _volume_u8()
    rays_np = _jax_rays()
    Z, Y, X = VOL_SHAPE
    with pltpu.force_tpu_interpret_mode(EAGER_INTERPRET):
        plan_j = JRK.CompositingPlan(*rays_np, (X, Y, Z), max_samples=24,
                                     lane_groups=lane_groups)
        assert plan_j.use_kernel and plan_j.group > 1
        if lane_groups is None:
            assert plan_j.lanes > 1
        _, _, parts_j = render_tf_grads_pallas(_jax_params(), J.as_normalized_volume(vol_u8),
                                               plan_j)
    plan = _plan(rays_np)
    ours = tf_march_steps(as_normalized_volume(vol_u8, device="cpu"), plan.entry_uv, plan.dir_step,
                          plan.hit.bool(), tf_scalars(_params()), plan.max_samples)
    assert float(ours[1].max()) > 0.9 and float(ours[2].max()) > 1.0
    for name, o, p in zip(NAMES, ours, parts_j):
        p = np.asarray(p)
        assert o.shape == p.shape == (32, 64), name
        bar = 1e-5 if name in ("color_T", "alpha_T") else 1e-5 * np.maximum(1.0, np.abs(p))
        assert np.all(np.abs(o.numpy() - p) <= bar), name


def test_render_tf_kernel_on_cpu_matches_jax_render_tf_and_grad():
    """``make_render_tf_kernel`` on CPU tensors (the plain march) vs JAX
    ``render_tf``: outputs within 1e-5, and the closed-form parameter
    gradients vs ``jax.grad`` through the jnp march within rtol 2e-4 and
    atol 2e-4 * max(1, |g|) (test_pallas_interpret.py:336-344), with general
    cotangents on both outputs."""
    import jax
    import jax.numpy as jnp

    import volumerenderer_tpu as J
    from volumerenderer_tpu.diff.transfer import render_tf as render_tf_jax

    vol_u8 = _volume_u8()
    e, d, h = _jax_rays()
    vol_j = J.as_normalized_volume(vol_u8)
    rng = np.random.default_rng(2)
    w_rgb = rng.standard_normal((32, 64, 3)).astype(np.float32)
    w_a = rng.standard_normal((32, 64)).astype(np.float32)

    def loss_ref(p):
        rgb, a = render_tf_jax(p, vol_j, e, d, h, max_samples=24)
        return jnp.sum(rgb * w_rgb) + jnp.sum(a * w_a)

    g_ref = jax.grad(loss_ref)(_jax_params())
    rgb_ref, a_ref = render_tf_jax(_jax_params(), vol_j, e, d, h, max_samples=24)

    before = (TK.tf_march_cuda.launches, TK.tf_march_cuda.f32_launches)
    f = TK.make_render_tf_kernel(_plan((e, d, h)))
    params = TFParams(*(t.requires_grad_(True) for t in _params()))
    rgb, a = f(params, as_normalized_volume(vol_u8, device="cpu"))
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(a_ref), atol=1e-5, rtol=0)
    loss = torch.sum(rgb * torch.tensor(w_rgb)) + torch.sum(a * torch.tensor(w_a))
    grads = torch.autograd.grad(loss, params)
    for name, g_t in zip(TFParams._fields, grads):
        g_r = np.asarray(getattr(g_ref, name))
        assert g_t.shape == g_r.shape, name
        np.testing.assert_allclose(g_t.numpy(), g_r, rtol=2e-4,
                                   atol=2e-4 * max(1.0, np.abs(g_r).max()), err_msg=name)
    # no kernel launched on CPU, on either route
    assert (TK.tf_march_cuda.launches, TK.tf_march_cuda.f32_launches) == before


def test_tf_fit_step_fast_matches_jax_step():
    """One step of the config-4 fit (lr 0.05, target 0.5) vs JAX's
    ``tf_fit_step_fast`` driving the jnp ``render_tf``: loss within 1e-6
    relative, new params within rtol 2e-4 / atol 1e-6 (the updates carry the
    gradients' 2e-4 bar)."""
    import jax.numpy as jnp

    import volumerenderer_tpu as J
    from volumerenderer_tpu.diff.transfer import TFParams as JTFParams
    from volumerenderer_tpu.diff.transfer import render_tf as render_tf_jax
    from volumerenderer_tpu.ops.pallas.tf_kernel import tf_fit_step_fast as step_jax

    vol_u8 = _volume_u8()
    e, d, h = _jax_rays()
    vol_j = J.as_normalized_volume(vol_u8)
    new_j, loss_j = step_jax(lambda p, v: render_tf_jax(p, v, e, d, h, max_samples=24),
                             JTFParams.reference(), vol_j,
                             jnp.full((32, 64, 3), 0.5, jnp.float32), lr=0.05)

    f = TK.make_render_tf_kernel(_plan((e, d, h)))
    params = TFParams.reference(device="cpu")
    new, loss = TK.tf_fit_step_fast(f, params, as_normalized_volume(vol_u8, device="cpu"),
                                    torch.full((32, 64, 3), 0.5), lr=0.05)
    assert loss.dim() == 0 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
    for name, n_t in zip(TFParams._fields, new):
        assert not n_t.requires_grad, name
        np.testing.assert_allclose(n_t.numpy(), np.asarray(getattr(new_j, name)), rtol=2e-4,
                                   atol=1e-6, err_msg=name)


def test_render_tf_kernel_volume_grad_is_zero_and_none_cotangents_count_as_zero():
    """The TF kernel treats the volume as a constant (gradient zeros, as in
    JAX); a loss on rgb alone leaves alpha's cotangent ``None``, which counts
    as zero, and a loss on alpha alone does the same for rgb."""
    vol = as_normalized_volume(_volume_u8(), device="cpu")
    plan = _plan(_jax_rays(32, 16))
    f = TK.make_render_tf_kernel(plan)
    params = TFParams(*(t.requires_grad_(True) for t in _params()))
    vt = vol.clone().requires_grad_(True)
    rgb, a = f(params, vt)
    *g_rgb_only, g_vol = torch.autograd.grad(torch.sum(rgb ** 2), [*params, vt])
    assert g_vol.shape == vol.shape and not bool(g_vol.any())
    rgb, a = f(params, vt)
    g_both = torch.autograd.grad(torch.sum(rgb ** 2) + torch.sum(a * 0.0), params)
    for x, y in zip(g_rgb_only, g_both):
        assert torch.equal(x, y)
    rgb, a = f(params, vt)
    g_alpha_only = torch.autograd.grad(torch.sum(a), params, allow_unused=True)
    assert float(g_alpha_only[0].abs()) > 0  # alpha depends on alpha_scale
    assert all(not bool(g.any()) for g in g_alpha_only[1:])


def test_render_tf_grads_kernel_returns_rgb_and_partials():
    vol = as_normalized_volume(_volume_u8(), device="cpu")
    plan = _plan(_jax_rays(32, 16))
    params = _params()
    rgb, alpha, partials = TK.render_tf_grads_kernel(params, vol, plan)
    assert rgb.shape == (16, 32, 3) and len(partials) == 7
    assert torch.equal(alpha, partials[1])
    assert torch.equal(rgb, params.flip_sign * partials[0][..., None] + params.flip_bias)


def _wrapper_inputs():
    rays = generate_rays(Camera(width=16, height=8), device="cpu")
    Z, Y, X = VOL_SHAPE
    return dict(volume=torch.from_numpy(_volume_u8()), entry_uv=rays.entry_uv,
                dir_step=(rays.direction * step_sizes((X, Y, Z), "cpu")).contiguous(),
                hit=rays.hit.to(torch.uint8), tf_scalars=tf_scalars(_params()))


def test_wrapper_cpu_runs_plain_version():
    before = (TK.tf_march_cuda.launches, TK.tf_march_cuda.f32_launches)
    kw = _wrapper_inputs()
    got = TK.tf_march_cuda(**kw, max_samples=16)
    ref = tf_march_steps(as_normalized_volume(kw["volume"]), kw["entry_uv"], kw["dir_step"],
                         kw["hit"].bool(), kw["tf_scalars"], 16)
    assert len(got) == 7 and all(torch.equal(g, r) for g, r in zip(got, ref))
    assert float(got[2].max()) > 0
    vol = as_normalized_volume(kw.pop("volume"))
    got_f32 = TK.tf_march_cuda(vol, **kw, max_samples=16)
    assert all(torch.equal(g, r) for g, r in zip(got_f32, ref))
    # no kernel launched on CPU, on either route
    assert (TK.tf_march_cuda.launches, TK.tf_march_cuda.f32_launches) == before


@pytest.mark.parametrize("field,value,match", [
    pytest.param("volume", lambda kw: kw["volume"].double(), "uint8", id="vol_u8-<lambda>-uint8"),
    pytest.param("volume", lambda kw: kw["volume"].transpose(0, 2), "contiguous",
                 id="vol_u8-<lambda>-contiguous"),
    ("entry_uv", lambda kw: kw["entry_uv"].double(), "float32"),
    ("dir_step", lambda kw: kw["dir_step"][:, :-1].contiguous(), "float32"),
    ("hit", lambda kw: kw["hit"].bool(), "uint8"),
    ("tf_scalars", lambda kw: kw["tf_scalars"].double(), "float32"),
    ("tf_scalars", lambda kw: kw["tf_scalars"].reshape(1, 3), "float32"),
    ("tf_scalars", lambda kw: kw["tf_scalars"].tolist(), "torch.Tensor"),
])
def test_wrapper_rejects_bad_inputs(field, value, match):
    kw = _wrapper_inputs()
    kw[field] = value(kw)
    with pytest.raises((ValueError, TypeError), match=match):
        TK.tf_march_cuda(**kw)


@pytest.mark.parametrize("kwargs,match", [
    (dict(max_samples=-1), "max_samples"),
    (dict(max_samples=2.5), "max_samples"),
    (dict(wrap="repeat"), "clamp-only"),
    (dict(wrap="mirror"), "wrap"),
])
def test_wrapper_rejects_bad_arguments(kwargs, match):
    with pytest.raises(ValueError, match=match):
        TK.tf_march_cuda(**_wrapper_inputs(), **kwargs)


def test_repeat_plan_is_refused():
    """The gradient marches are clamp-only, as the TPU kernels' plans: a plan
    with ``wrap="repeat"`` is refused where it is bound."""
    plan = _plan(_jax_rays(32, 16), wrap="repeat")
    with pytest.raises(ValueError, match="clamp-only"):
        TK.make_render_tf_kernel(plan)
    with pytest.raises(ValueError, match="clamp-only"):
        TK.render_tf_grads_kernel(_params(), as_normalized_volume(_volume_u8(), device="cpu"), plan)


def test_mismatched_volume_is_refused():
    f = TK.make_render_tf_kernel(_plan(_jax_rays(32, 16)))
    with pytest.raises(ValueError, match="does not match"):
        f(_params(), torch.zeros(8, 16, 64))


@pytest.mark.parametrize("name", ["tf_march", "voxel_grad"])
def test_gradient_kernels_build_with_the_shared_sampler(tmp_path, name):
    """Both gradient kernels include ``trilinear.cuh`` (the sampler and its
    adjoint), so an edit to it builds them anew: their cache key covers it."""
    import shutil

    from volumerenderer_tpu_torch.ops.cuda import _build

    assert '#include "trilinear.cuh"' in (_build.CSRC_DIR / f"{name}.cu").read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    before = _build.library_path(name, csrc, tmp_path)
    header = csrc / "trilinear.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert _build.library_path(name, csrc, tmp_path) != before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_scene(device):
    vol_u8 = torch.from_numpy(turbulence_volume((64, 48, 96), seed=1)).to(device)
    rays = generate_rays(Camera(width=96, height=64, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device=device)
    Z, Y, X = vol_u8.shape
    dir_step = (rays.direction * step_sizes((X, Y, Z), device)).contiguous()
    return vol_u8, rays, dir_step


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["reference", "non_reference"])
def test_kernel_matches_plain_on_cuda(cuda_device, kind):
    """The CUDA kernel vs the plain version on the same card and inputs:
    built with --fmad=false in the plain version's op order, so all seven
    images agree to 1e-6 relative to max(1, |plain|) on every pixel."""
    vol_u8, rays, dir_step = _card_scene(cuda_device)
    params = TFParams.reference(cuda_device) if kind == "reference" else _params(cuda_device)
    tf = tf_scalars(params)
    before = TK.tf_march_cuda.launches
    got = TK.tf_march_cuda(vol_u8, rays.entry_uv, dir_step, rays.hit.to(torch.uint8), tf)
    torch.cuda.synchronize()
    assert TK.tf_march_cuda.launches == before + 1
    ref = tf_march_steps(as_normalized_volume(vol_u8), rays.entry_uv, dir_step, rays.hit, tf)
    assert float(ref[1].max()) > 0.5
    for name, k, p in zip(NAMES, got, ref):
        d = (k - p).abs() / torch.clamp(p.abs(), min=1.0)
        assert float(d.max()) <= 1e-6, name


@pytest.mark.cuda
def test_kernel_at_reference_params_equals_compositing_march_on_cuda(cuda_device):
    """At TFParams.reference() (s*1 + 0 == s) color and alpha are the
    compositing march kernel's, bit for bit: its rgb is the reference
    transfer of this color."""
    vol_u8, rays, dir_step = _card_scene(cuda_device)
    hit = rays.hit.to(torch.uint8)
    got = TK.tf_march_cuda(vol_u8, rays.entry_uv, dir_step, hit,
                           tf_scalars(TFParams.reference(cuda_device)))
    rgb, a = RK.composite_march_cuda(vol_u8, rays.entry_uv, dir_step, hit)
    torch.cuda.synchronize()
    assert torch.equal(apply_reference_transfer(got[0], got[1]), rgb)
    assert torch.equal(got[1], a)
