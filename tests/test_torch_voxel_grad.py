"""The port's voxel-gradient march: its plain version
(``diff/closed_form.py::voxel_grad_steps``), its wrapper
(``ops/cuda/voxel_grad_kernel.py::voxel_grad_cuda``) and
``make_render_tf_voxel``.

On CPU tensors the wrapper runs the plain version.  The differentiable
render's voxel gradient is held against the JAX package's ``render_tf_o1``
(itself checked by finite differences) within
tests/test_pallas_interpret.py:417-427's bars, and the plain version against
the JAX voxel-gradient kernel run in interpret mode.  The kernel itself runs
only where there is a CUDA device: the ``cuda``-marked tests hold it against
the plain version there.

The machine with the card has no JAX, so this file imports JAX only inside
the tests that compare with it; there the card's tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_voxel_grad.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.diff.closed_form import (cotangent_images, step_cotangents,
                                                       tf_march_steps, tf_scalars,
                                                       voxel_grad_steps)
from volumerenderer_tpu_torch.diff.vjp import render_tf_o1
from volumerenderer_tpu_torch.interop import rays_from_numpy, tf_params_from_numpy
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.cuda import voxel_grad_kernel as VK
from volumerenderer_tpu_torch.ops.raycast import MAX_SAMPLES, step_sizes

VOL_SHAPE = (8, 16, 128)  # (Z, Y, X), the interpret-mode tests' volume
NON_REFERENCE = dict(alpha_scale=0.45, color_gain=0.9, color_bias=0.05,
                     flip_sign=[-0.8, 0.6, 0.3], flip_bias=[0.9, 0.2, 0.4])


def _volume_u8():
    rng = np.random.default_rng(7)
    return np.round(rng.random(VOL_SHAPE) * 255.0).astype(np.uint8)


def _params(device="cpu"):
    return tf_params_from_numpy(device=device, **NON_REFERENCE)


def _jax_params():
    import jax.numpy as jnp
    from volumerenderer_tpu.diff.transfer import TFParams as JTFParams

    return JTFParams(**{k: jnp.asarray(v, jnp.float32) for k, v in NON_REFERENCE.items()})


def _jax_rays(width=64, height=32):
    import volumerenderer_tpu as J

    rays = J.generate_rays(J.Camera(width=width, height=height))
    return tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


def _plan(rays_np, max_samples=24):
    rays = rays_from_numpy(*rays_np, device="cpu")
    Z, Y, X = VOL_SHAPE
    return RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z),
                              max_samples=max_samples)


def _cotangents(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape + (3,)).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_render_tf_voxel_on_cpu_matches_jax_o1():
    """``make_render_tf_voxel`` on CPU tensors vs JAX ``render_tf_o1`` on the
    8-bit grid's volume, general cotangents on both outputs: g_vol within
    2e-4 * max(1, max |g|), params within rtol 2e-4 and atol 2e-4 * max(1,
    |g|) (test_pallas_interpret.py:417-427)."""
    import jax
    import jax.numpy as jnp

    import volumerenderer_tpu as J
    from volumerenderer_tpu.diff.vjp import render_tf_o1 as render_tf_o1_jax

    vol_u8 = _volume_u8()
    e, d, h = rays_np = _jax_rays()
    w_rgb, w_a = _cotangents(5, (32, 64))

    def loss_ref(p, v):
        rgb, a = render_tf_o1_jax(p, v, e, d, h, 24, True)
        return jnp.sum(rgb * w_rgb) + jnp.sum(a * w_a)

    gp_ref, gv_ref = jax.grad(loss_ref, argnums=(0, 1))(_jax_params(),
                                                        J.as_normalized_volume(vol_u8))

    before = VK.voxel_grad_cuda.launches
    f = VK.make_render_tf_voxel(_plan(rays_np))
    params = TFParams(*(t.requires_grad_(True) for t in _params()))
    vt = as_normalized_volume(vol_u8, device="cpu").requires_grad_(True)
    rgb, a = f(params, vt)
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
    assert VK.voxel_grad_cuda.launches == before  # no kernel launched on CPU


def test_voxel_grad_steps_matches_jax_voxel_grad_kernel():
    """The plain version vs the TPU kernel (``voxel_grad_pallas``, interpret
    mode, dense word table) on the same cotangents and the TPU forward's
    (alpha_T, P_total): within 1e-5 * max(1, max |g|) (the TPU kernel
    lerps on the 0..255 scale and sums its MXU scatter in another order)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    import volumerenderer_tpu as J
    from volumerenderer_tpu.ops.pallas import raycast_kernel as JRK
    from volumerenderer_tpu.ops.pallas.tf_kernel import render_tf_grads_pallas
    from volumerenderer_tpu.ops.pallas.voxel_grad_kernel import voxel_grad_pallas
    from conftest import EAGER_INTERPRET

    vol_u8 = _volume_u8()
    rays_np = _jax_rays()
    Z, Y, X = VOL_SHAPE
    g_rgb, g_a = _cotangents(5, (32, 64))
    vol_j = J.as_normalized_volume(vol_u8)
    with pltpu.force_tpu_interpret_mode(EAGER_INTERPRET):
        plan_j = JRK.CompositingPlan(*rays_np, (X, Y, Z), max_samples=24, lane_groups=1)
        assert plan_j.use_kernel and plan_j.group > 1
        _, _, parts = render_tf_grads_pallas(_jax_params(), vol_j, plan_j)
        gv_j = np.asarray(voxel_grad_pallas(_jax_params(), vol_j, plan_j, jnp.asarray(g_rgb),
                                            jnp.asarray(g_a), parts[1], parts[3]))
    plan = _plan(rays_np)
    params = _params()
    alpha_T, P_tot = (torch.tensor(np.asarray(parts[i])) for i in (1, 3))
    gc, gaT_term = cotangent_images(params, torch.tensor(g_rgb), torch.tensor(g_a), alpha_T)
    gv = voxel_grad_steps(as_normalized_volume(vol_u8, device="cpu"), plan.entry_uv, plan.dir_step,
                          plan.hit.bool(), tf_scalars(params), gc, gaT_term, P_tot,
                          plan.max_samples)
    assert np.abs(gv_j).max() > 0.5
    np.testing.assert_allclose(gv.numpy(), gv_j, rtol=0, atol=1e-5 * max(1.0, np.abs(gv_j).max()))


def _wrapper_inputs():
    rays = generate_rays(Camera(width=16, height=8), device="cpu")
    Z, Y, X = VOL_SHAPE
    vol_u8 = torch.from_numpy(_volume_u8())
    dir_step = (rays.direction * step_sizes((X, Y, Z), "cpu")).contiguous()
    hit = rays.hit.to(torch.uint8)
    tf = tf_scalars(_params())
    partials = tf_march_steps(as_normalized_volume(vol_u8, device="cpu"), rays.entry_uv, dir_step,
                              rays.hit, tf, 32)
    g_rgb, g_a = (torch.tensor(x) for x in _cotangents(9, (8, 16)))
    gc, gaT_term = cotangent_images(_params(), g_rgb, g_a, partials[1])
    return dict(volume=vol_u8, entry_uv=rays.entry_uv, dir_step=dir_step, hit=hit,
                tf_scalars=tf, gc=gc, gaT_term=gaT_term, P_tot=partials[3])


def test_wrapper_cpu_runs_plain_version_and_conserves_cotangent():
    """On CPU the wrapper is the plain version.  The trilinear weights of a
    sample sum to 1, so the gradient volume's sum equals the sum of every
    alive step's g_s (to float32 rounding, 1e-5 of sum |g_s|)."""
    before = VK.voxel_grad_cuda.launches
    kw = _wrapper_inputs()
    got = VK.voxel_grad_cuda(**kw, max_samples=32)
    args = (as_normalized_volume(kw["volume"]), kw["entry_uv"], kw["dir_step"],
            kw["hit"].bool(), kw["tf_scalars"], kw["gc"], kw["gaT_term"], kw["P_tot"], 32)
    assert torch.equal(got, voxel_grad_steps(*args))
    assert VK.voxel_grad_cuda.launches == before  # no kernel launched on CPU
    steps = [g_s.double() for _, g_s in step_cotangents(*args)]
    total = float(sum(g.sum() for g in steps))
    scale = float(sum(g.abs().sum() for g in steps))
    assert scale > 1.0
    assert abs(float(got.double().sum()) - total) <= 1e-5 * scale


def test_voxel_grad_kernel_counts_none_cotangents_as_zero():
    vol = as_normalized_volume(_volume_u8(), device="cpu")
    plan = _plan(_jax_rays(32, 16))
    params = _params()
    from volumerenderer_tpu_torch.ops.cuda.tf_kernel import render_tf_grads_kernel

    _, alpha, partials = render_tf_grads_kernel(params, vol, plan)
    g_rgb = torch.tensor(_cotangents(3, (16, 32))[0])
    a = VK.voxel_grad_kernel(params, vol, plan, g_rgb, None, alpha, partials[3])
    b = VK.voxel_grad_kernel(params, vol, plan, g_rgb, torch.zeros_like(alpha), alpha,
                             partials[3])
    assert torch.equal(a, b) and float(a.abs().max()) > 0


@pytest.mark.parametrize("field,value,match", [
    ("gc", lambda kw: kw["gc"].double(), "float32"),
    ("gaT_term", lambda kw: kw["gaT_term"][:-1].contiguous(), "float32"),
    ("P_tot", lambda kw: kw["P_tot"].reshape(-1), "float32"),
    ("P_tot", lambda kw: kw["P_tot"].t(), "contiguous"),
    ("tf_scalars", lambda kw: kw["tf_scalars"][:2], "float32"),
    ("hit", lambda kw: kw["hit"].bool(), "uint8"),
    pytest.param("volume", lambda kw: kw["volume"][0], "uint8", id="vol_u8-<lambda>-uint8"),
])
def test_wrapper_rejects_bad_inputs(field, value, match):
    kw = _wrapper_inputs()
    kw[field] = value(kw)
    with pytest.raises((ValueError, TypeError), match=match):
        VK.voxel_grad_cuda(**kw)


@pytest.mark.parametrize("kwargs,match", [
    (dict(max_samples=-1), "max_samples"),
    (dict(wrap="repeat"), "clamp-only"),
])
def test_wrapper_rejects_bad_arguments(kwargs, match):
    with pytest.raises(ValueError, match=match):
        VK.voxel_grad_cuda(**_wrapper_inputs(), **kwargs)


def test_repeat_plan_is_refused():
    rays = rays_from_numpy(*_jax_rays(32, 16), device="cpu")
    Z, Y, X = VOL_SHAPE
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), wrap="repeat")
    with pytest.raises(ValueError, match="clamp-only"):
        VK.make_render_tf_voxel(plan)


def _alive_positions(vol_u8, rays, dims, K, max_samples):
    """numpy float32 replay of the voxel-gradient march's alive steps: per
    ray, the positions p_i = p_{i-1} + d while inside the open cube, up to
    and including the step whose alpha a = a + (s - s*a)*K passes 0.99."""
    from volumerenderer_tpu_torch.ops.sampling import sample_trilinear

    vol = as_normalized_volume(vol_u8, device="cpu")
    entry = rays.entry_uv.numpy().reshape(-1, 3).astype(np.float32)
    d = (rays.direction * step_sizes(dims, "cpu")).numpy().reshape(-1, 3).astype(np.float32)
    hit = rays.hit.numpy().reshape(-1)
    p = entry.copy()
    a = np.zeros(len(p), np.float32)
    alive = hit.copy()
    steps = []
    for _ in range(max_samples):
        p = p + d
        alive &= ((p > 0) & (p < 1)).all(axis=1)
        if not alive.any():
            break
        steps.append((p.copy(), alive.copy()))
        s = sample_trilinear(vol, torch.from_numpy(p)).numpy()
        a = np.where(alive, a + (s - s * a) * np.float32(K), a).astype(np.float32)
        alive &= a <= np.float32(0.99)
    return steps


@pytest.mark.parametrize("block", [(8, 8), (16, 8)])
def test_block_box_holds_every_alive_tap(block):
    """The tile design of csrc/voxel_grad.cu: a ray's positions are monotone
    per axis, so every tap of its alive steps lies in the box of its first
    and last alive anchors (clamped, the upper one + 1), and a block's union
    of those boxes holds all of its rays' taps (the kernel's 8x8 blocks, and
    16x8)."""
    bw, bh = block
    rng = np.random.default_rng(11)
    vol_u8 = np.round(rng.random((24, 40, 56)) * 60.0).astype(np.uint8)  # dim: deep rays
    Z, Y, X = vol_u8.shape
    n = np.array([X, Y, Z])
    H, W = 24, 32
    rays = generate_rays(Camera(width=W, height=H, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device="cpu")
    steps = _alive_positions(vol_u8, rays, (X, Y, Z), 0.45, 96)
    anchors = [np.floor(p * n.astype(np.float32) - np.float32(0.5)).astype(np.int64)
               for p, _ in steps]
    alive = np.stack([al for _, al in steps])                       # (steps, rays)
    anc = np.stack(anchors)                                         # (steps, rays, 3)
    assert alive.sum(axis=0).max() > 20
    first = np.argmax(alive, axis=0)
    last = alive.shape[0] - 1 - np.argmax(alive[::-1], axis=0)
    rows = np.arange(anc.shape[1])
    f, l = anc[first, rows], anc[last, rows]
    lo = np.clip(np.minimum(f, l), 0, n - 1)
    hi = np.clip(np.maximum(f, l) + 1, 0, n - 1)
    has = alive.any(axis=0)
    rows, cols = np.arange(H)[:, None] // bh, np.arange(W)[None] // bw
    for by in range(H // bh):
        for bx in range(W // bw):
            sel = ((rows == by) & (cols == bx)).reshape(-1) & has
            box_lo, box_hi = lo[sel].min(axis=0), hi[sel].max(axis=0)
            taps = np.concatenate([np.clip(anc + off, 0, n - 1)[alive & sel[None]]
                                   for off in (0, 1)])
            assert (taps >= box_lo).all() and (taps <= box_hi).all(), (by, bx)


def test_block_stats_need_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        VK.voxel_grad_block_stats(**_wrapper_inputs())


def _port_plan(width, height, device="cpu"):
    """The port's own rays (no JAX) over VOL_SHAPE, 24 steps."""
    rays = generate_rays(Camera(width=width, height=height), device=device)
    Z, Y, X = VOL_SHAPE
    return RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z),
                              max_samples=24)


def _leaving_volume(vol_u8: torch.Tensor, dim: float = 1.0) -> torch.Tensor:
    """A float32 volume that leaves [0, 1] on both sides, built from a byte
    volume: (v * 1.25 - 0.1) * dim, with exact halves (k + 0.5) / 255, -0.0,
    +inf and -inf planted at fixed voxels."""
    v = (as_normalized_volume(vol_u8) * 1.25 - 0.1) * dim
    flat = v.view(-1)
    n = flat.numel()
    k = torch.arange(0, 255, 7, device=v.device, dtype=torch.float32)
    flat[(torch.arange(k.numel(), device=v.device) * 37) % n] = (k + 0.5) / 255.0
    flat[[n // 3, n // 3 + 1, n // 2, 2 * n // 3]] = torch.tensor(
        [-0.0, float("inf"), float("-inf"), 1.5], device=v.device)
    return v


def test_float32_volume_on_cpu_equals_the_byte_route_on_its_quantize():
    """``voxel_grad_cuda`` and ``voxel_grad_kernel`` given a CPU float32
    volume that leaves [0, 1] (halves, -0.0, +-inf) give, bit for bit, the
    byte route on ``quantize_u8`` of it; no kernel is launched."""
    kw = _wrapper_inputs()
    vol_f = _leaving_volume(kw["volume"])
    vol_u8 = RK.quantize_u8(vol_f)
    assert vol_u8.min() == 0 and vol_u8.max() == 255
    before = (VK.voxel_grad_cuda.launches, VK.voxel_grad_cuda.f32_launches)
    got = VK.voxel_grad_cuda(**{**kw, "volume": vol_f}, max_samples=32)
    want = VK.voxel_grad_cuda(**{**kw, "volume": vol_u8}, max_samples=32)
    assert float(want.abs().max()) > 0 and torch.equal(got, want)

    plan = _port_plan(32, 16)
    params = _params()
    from volumerenderer_tpu_torch.ops.cuda.tf_kernel import render_tf_grads_kernel

    vol_f = _leaving_volume(torch.from_numpy(_volume_u8()))
    vol_u8 = RK.quantize_u8(vol_f)
    _, alpha, partials = render_tf_grads_kernel(params, vol_u8, plan)
    g_rgb = torch.tensor(_cotangents(4, (16, 32))[0])
    got = VK.voxel_grad_kernel(params, vol_f, plan, g_rgb, None, alpha, partials[3])
    want = VK.voxel_grad_kernel(params, vol_u8, plan, g_rgb, None, alpha, partials[3])
    assert float(want.abs().max()) > 0 and torch.equal(got, want)
    assert (VK.voxel_grad_cuda.launches, VK.voxel_grad_cuda.f32_launches) == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.int16])
@pytest.mark.parametrize("entry", ["voxel_grad_cuda", "voxel_grad_block_stats",
                                   "voxel_grad_kernel"])
def test_other_volume_dtypes_raise(entry, dtype):
    kw = _wrapper_inputs()
    kw["volume"] = kw["volume"].to(dtype)
    with pytest.raises(ValueError, match="float32"):
        if entry == "voxel_grad_kernel":
            plan = _port_plan(16, 8)
            g_rgb = torch.zeros((8, 16, 3))
            alpha = torch.zeros((8, 16))
            VK.voxel_grad_kernel(_params(), kw["volume"], plan, g_rgb, None, alpha, alpha)
        else:
            getattr(VK, entry)(**kw)


@pytest.mark.parametrize("dtype,entry", [(torch.uint8, "voxel_grad"),
                                         (torch.float32, "voxel_grad_f32")])
def test_launch_takes_the_entry_of_the_volume_dtype(monkeypatch, dtype, entry):
    """``_launch_vg`` launches the C entry point of the volume's dtype, with
    the volume's own pointer, and counts the launch in the total and, for a
    float32 volume, in ``f32_launches`` (the launch itself stubbed: no card
    here)."""
    calls = []

    def fake_launcher(name="voxel_grad"):
        return (lambda *args: calls.append((name, args)) or 0), None

    def fake_launch(launcher, name, device, *args):
        fn, _ = launcher()
        assert fn(*args, None) == 0

    monkeypatch.setattr(VK, "_launcher", fake_launcher)
    monkeypatch.setattr(VK, "launch", fake_launch)
    kw = _wrapper_inputs()
    kw["volume"] = kw["volume"].to(dtype)
    before = (VK.voxel_grad_cuda.launches, VK.voxel_grad_cuda.f32_launches)
    VK._launch_vg(kw, 32, torch.zeros(kw["volume"].shape), None)
    assert [c[0] for c in calls] == [entry]
    assert calls[0][1][3] == kw["volume"].data_ptr()
    assert (VK.voxel_grad_cuda.launches, VK.voxel_grad_cuda.f32_launches) == (
        before[0] + 1, before[1] + (dtype == torch.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["reference", "non_reference"])
def test_kernel_matches_plain_on_cuda(cuda_device, kind):
    """The CUDA kernel vs the plain version on the same card and inputs,
    seeded cotangents.  The atomics add in no fixed order, so the bar is
    2e-5 of max |g|, ten times inside test_pallas_interpret.py's 2e-4."""
    vol_u8 = torch.from_numpy(turbulence_volume((64, 48, 96), seed=1)).to(cuda_device)
    rays = generate_rays(Camera(width=96, height=64, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device=cuda_device)
    Z, Y, X = vol_u8.shape
    dir_step = (rays.direction * step_sizes((X, Y, Z), cuda_device)).contiguous()
    params = TFParams.reference(cuda_device) if kind == "reference" else _params(cuda_device)
    tf = tf_scalars(params)
    vol = as_normalized_volume(vol_u8)
    partials = tf_march_steps(vol, rays.entry_uv, dir_step, rays.hit, tf)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    g_rgb = torch.randn((64, 96, 3), generator=gen, device=cuda_device)
    g_a = torch.randn((64, 96), generator=gen, device=cuda_device)
    gc, gaT_term = cotangent_images(params, g_rgb, g_a, partials[1])
    before = VK.voxel_grad_cuda.launches
    got = VK.voxel_grad_cuda(vol_u8, rays.entry_uv, dir_step, rays.hit.to(torch.uint8), tf, gc,
                             gaT_term, partials[3])
    torch.cuda.synchronize()
    assert VK.voxel_grad_cuda.launches == before + 1
    ref = voxel_grad_steps(vol, rays.entry_uv, dir_step, rays.hit, tf, gc, gaT_term, partials[3])
    scale = float(ref.abs().max())
    assert scale > 0.5
    assert float((got - ref).abs().max()) <= 2e-5 * scale


@pytest.mark.cuda
def test_render_tf_voxel_matches_o1_on_cuda(cuda_device):
    """The whole kernel path on the card (B4 forward, B5 backward) vs the
    plain O(1) VJP on the same card, on test_pallas_interpret.py's scene
    (24 steps) and bars."""
    vol = as_normalized_volume(_volume_u8(), device=cuda_device)
    rays = generate_rays(Camera(width=64, height=32), device=cuda_device)
    Z, Y, X = VOL_SHAPE
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), 24)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    w_rgb = torch.randn((32, 64, 3), generator=gen, device=cuda_device)
    w_a = torch.randn((32, 64), generator=gen, device=cuda_device)
    grads = []
    for f in (VK.make_render_tf_voxel(plan),
              lambda p, v: render_tf_o1(p, v, rays.entry_uv, rays.direction, rays.hit, 24)):
        params = TFParams(*(t.requires_grad_(True) for t in _params(cuda_device)))
        vt = vol.clone().requires_grad_(True)
        rgb, a = f(params, vt)
        grads.append(torch.autograd.grad(torch.sum(rgb * w_rgb) + torch.sum(a * w_a),
                                         [*params, vt]))
    (*gp_k, gv_k), (*gp_r, gv_r) = grads
    scale = max(1.0, float(gv_r.abs().max()))
    assert float((gv_k - gv_r).abs().max()) <= 2e-4 * scale
    for name, k, r in zip(TFParams._fields, gp_k, gp_r):
        bar = 2e-4 * r.abs() + 2e-4 * max(1.0, float(r.abs().max()))
        assert bool(((k - r).abs() <= bar).all()), name


def _deep_scene(device, dim):
    """Orbit-like 256x192 rays over a 64x48x96 turbulence scaled by ``dim``,
    reference params, MSE cotangents: the inputs of one voxel-grad launch."""
    vol_u8 = torch.from_numpy(turbulence_volume((64, 48, 96), seed=1)).to(device)
    vol_u8 = RK.quantize_u8(as_normalized_volume(vol_u8) * dim)
    rays = generate_rays(Camera(width=256, height=192, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device=device)
    Z, Y, X = vol_u8.shape
    dir_step = (rays.direction * step_sizes((X, Y, Z), device)).contiguous()
    params = TFParams.reference(device)
    tf = tf_scalars(params)
    vol = as_normalized_volume(vol_u8)
    partials = tf_march_steps(vol, rays.entry_uv, dir_step, rays.hit, tf)
    rgb = params.flip_sign * partials[0][..., None] + params.flip_bias
    gc, gaT_term = cotangent_images(params, (rgb - 0.5) * (2.0 / rgb.numel()), None, partials[1])
    kw = dict(volume=vol_u8, entry_uv=rays.entry_uv, dir_step=dir_step,
              hit=rays.hit.to(torch.uint8), tf_scalars=tf, gc=gc, gaT_term=gaT_term,
              P_tot=partials[3])
    ref = voxel_grad_steps(vol, rays.entry_uv, dir_step, rays.hit, tf, gc, gaT_term, partials[3])
    return kw, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dim,path", [(1.0, "tiled"), (0.02, "global")])
def test_kernel_paths_match_plain_on_cuda(cuda_device, dim, path):
    """An oblique camera on the turbulence: every block accumulates in its
    shared tile; dimmed to 2 %, the rays run deep, the boxes overflow the
    tile budget and every block adds to device memory.  Both within 2e-5 of
    max |g| of the plain version."""
    kw, ref = _deep_scene(cuda_device, dim)
    g, stats = VK.voxel_grad_block_stats(**kw)
    got = VK.voxel_grad_cuda(**kw)
    torch.cuda.synchronize()
    assert stats[path] >= 0.9 * (stats["blocks"] - stats["empty"]) > 0, stats
    scale = float(ref.abs().max())
    assert scale > 0
    for out in (g, got):
        assert float((out - ref).abs().max()) <= 2e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dim,path", [(1.0, "tiled"), (0.02, "global")])
def test_f32_route_matches_byte_route_on_cuda(cuda_device, dim, path):
    """B5 on a float32 volume that leaves [0, 1] against B5 on
    ``quantize_u8`` of it, on both of the kernel's paths: the taps are
    bit-equal, so every block's box voxels, global adds and alive steps are
    the same, and both gradients lie within 2e-5 of max |g| of the plain
    version (the atomics add in no fixed order)."""
    kw, _ = _deep_scene(cuda_device, 1.0)
    vol_f = _leaving_volume(kw["volume"], dim)
    vol_u8 = RK.quantize_u8(vol_f)
    assert vol_u8.min() == 0 and (dim < 1 or vol_u8.max() == 255)
    plain = as_normalized_volume(vol_u8)
    partials = tf_march_steps(plain, kw["entry_uv"], kw["dir_step"], kw["hit"].bool(),
                              kw["tf_scalars"])
    params = TFParams.reference(cuda_device)
    rgb = params.flip_sign * partials[0][..., None] + params.flip_bias
    gc, gaT_term = cotangent_images(params, (rgb - 0.5) * (2.0 / rgb.numel()), None, partials[1])
    kw.update(gc=gc, gaT_term=gaT_term, P_tot=partials[3])
    ref = voxel_grad_steps(plain, kw["entry_uv"], kw["dir_step"], kw["hit"].bool(),
                           kw["tf_scalars"], gc, gaT_term, partials[3])
    lib = VK.load_kernel().lib
    H, W = kw["hit"].shape
    n_blocks = -(-H // lib.voxel_grad_block_y()) * -(-W // lib.voxel_grad_block_x())
    out = {}
    for name, vol in (("u8", vol_u8), ("f32", vol_f)):
        before = (VK.voxel_grad_cuda.launches, VK.voxel_grad_cuda.f32_launches)
        tensors = VK._checked_inputs(**{**kw, "volume": vol}, max_samples=MAX_SAMPLES,
                                     wrap="clamp")
        stats = torch.zeros((n_blocks, 3), dtype=torch.int32, device=cuda_device)
        g = torch.zeros(vol.shape, dtype=torch.float32, device=cuda_device)
        VK._launch_vg(tensors, MAX_SAMPLES, g, stats)
        g_summary, summary = VK.voxel_grad_block_stats(**{**kw, "volume": vol})
        g_wrapper = VK.voxel_grad_cuda(**{**kw, "volume": vol})
        torch.cuda.synchronize()
        assert (VK.voxel_grad_cuda.launches, VK.voxel_grad_cuda.f32_launches) == (
            before[0] + 3, before[1] + 3 * (name == "f32"))
        out[name] = (stats, summary, (g, g_summary, g_wrapper))
    assert torch.equal(out["f32"][0], out["u8"][0])
    assert out["f32"][1] == out["u8"][1]
    summary = out["f32"][1]
    assert summary[path] >= 0.9 * (summary["blocks"] - summary["empty"]) > 0, summary
    scale = float(ref.abs().max())
    assert scale > 0
    for g in (*out["u8"][2], *out["f32"][2]):
        assert float((g - ref).abs().max()) <= 2e-5 * scale


@pytest.mark.cuda
def test_card_fit_step_on_float32_makes_no_byte_copy(cuda_device, monkeypatch):
    """A fit step through ``make_render_tf_voxel`` on a float32 volume that
    leaves [0, 1], on the card: one launch of B5's float32 route and none of
    its byte route, no ``quantize_u8`` called, no ``vr.voxel_grad.quantize``
    span inside ``vr.voxel_grad``; its voxel gradient within 2e-5 of max |g|
    of the byte route's (``voxel_grad_kernel`` on ``quantize_u8`` of the
    volume, fed the same step's cotangents)."""
    from torch.profiler import ProfilerActivity, profile

    vol_u8 = torch.from_numpy(turbulence_volume((64, 48, 96), seed=1)).to(cuda_device)
    vol_f = _leaving_volume(vol_u8)
    rays = generate_rays(Camera(width=96, height=64, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device=cuda_device)
    Z, Y, X = vol_f.shape
    plan = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    f = VK.make_render_tf_voxel(plan)
    target = torch.full((64, 96, 3), 0.5, device=cuda_device)

    def step(vol):
        leaves = [t.clone().requires_grad_(True) for t in _params(cuda_device)]
        v = vol.clone().requires_grad_(True)
        rgb, _ = f(TFParams(*leaves), v)
        return torch.autograd.grad(torch.mean((rgb - target) ** 2), [*leaves, v])[-1]

    # the byte route on the same step's cotangents, made before the count
    from volumerenderer_tpu_torch.ops.cuda.tf_kernel import render_tf_grads_kernel

    params, vol_u8 = _params(cuda_device), RK.quantize_u8(vol_f)
    rgb, _, partials = render_tf_grads_kernel(params, vol_u8, plan)
    g_rgb = (rgb - target) * (2.0 / rgb.numel())
    want = VK.voxel_grad_kernel(params, vol_u8, plan, g_rgb, None, partials[1], partials[3])
    quantized = []
    for mod in (RK, VK):
        monkeypatch.setattr(mod, "quantize_u8", lambda v: quantized.append(v) or v)
    before = (VK.voxel_grad_cuda.launches, VK.voxel_grad_cuda.f32_launches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = step(vol_f)
        torch.cuda.synchronize()
    spans = {e.name for e in prof.events() if e.name.startswith("vr.")}
    assert "vr.voxel_grad" in spans and "vr.voxel_grad.quantize" not in spans, spans
    assert quantized == []
    assert (VK.voxel_grad_cuda.launches, VK.voxel_grad_cuda.f32_launches) == (
        before[0] + 1, before[1] + 1)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 2e-5 * scale
