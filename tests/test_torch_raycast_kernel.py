"""The port's march wrapper and ``CompositingPlan``.

On CPU tensors the wrapper runs the plain PyTorch march; the plan is held
against the JAX package's ``CompositingPlan`` with its Pallas kernel run in
interpret mode, as tests/test_pallas_interpret.py runs it, within the 1e-5 bar
of that file.  The kernel itself runs only where there is a CUDA device: the
``cuda``-marked tests hold it against the plain version there.

The machine with the card has no JAX, so this file imports JAX only inside
the tests that compare with it; there the card's tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_raycast_kernel.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import as_normalized_volume
from volumerenderer_tpu_torch.interop import rays_from_numpy
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.raycast import composite_march_steps, step_sizes

VOL_SHAPE = (8, 16, 128)  # (Z, Y, X), the interpret-mode tests' volume


def _volume_u8():
    rng = np.random.default_rng(7)
    return np.round(rng.random(VOL_SHAPE) * 255.0).astype(np.uint8)


def _jax_rays(width=64, height=32):
    import volumerenderer_tpu as J

    rays = J.generate_rays(J.Camera(width=width, height=height))
    return tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


def test_plan_matches_jax_pallas_plan():
    from jax.experimental.pallas import tpu as pltpu

    import volumerenderer_tpu as J
    from volumerenderer_tpu.ops.pallas import raycast_kernel as JK
    from conftest import EAGER_INTERPRET

    vol_u8 = _volume_u8()
    entry_uv, direction, hit = _jax_rays()
    Z, Y, X = VOL_SHAPE
    vol_j = J.as_normalized_volume(vol_u8)
    with pltpu.force_tpu_interpret_mode(EAGER_INTERPRET):
        plan_j = JK.CompositingPlan(entry_uv, direction, hit, (X, Y, Z), max_samples=24)
        assert plan_j.use_kernel
        rgb_j, a_j = plan_j.render(vol_j)
    rays = rays_from_numpy(entry_uv, direction, hit, device="cpu")
    plan_t = RK.CompositingPlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z),
                                max_samples=24)
    rgb_t, a_t = plan_t.render(as_normalized_volume(vol_u8, device="cpu"))
    assert rgb_t.shape == (32, 64, 3) and a_t.shape == (32, 64)
    assert float(a_t.max()) > 0.5
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)


def test_render_compositing_kernel_cpu_equals_plain():
    """On CPU the kernel entry point is the plain march on the 8-bit grid:
    equal to ``render_compositing`` for a byte-derived volume, both wraps."""
    from volumerenderer_tpu_torch.ops.raycast import render_compositing

    vol = as_normalized_volume(_volume_u8(), device="cpu")
    rays = rays_from_numpy(*_jax_rays(32, 16), device="cpu")
    for wrap in ("clamp", "repeat"):
        got = RK.render_compositing_kernel(vol, rays.entry_uv, rays.direction, rays.hit,
                                           max_samples=20, wrap=wrap)
        ref = render_compositing(vol, rays.entry_uv, rays.direction, rays.hit,
                                 max_samples=20, wrap=wrap)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def test_quantize_u8_round_trips_bytes():
    v = _volume_u8()
    assert torch.equal(RK.quantize_u8(as_normalized_volume(v, device="cpu")), torch.from_numpy(v))
    q = RK.quantize_u8(torch.tensor([-0.5, 0.0, 0.5 / 255, 1.5 / 255, 1.0, 2.0]))
    assert q.tolist() == [0, 0, 0, 2, 255, 255]


def _wrapper_inputs():
    from volumerenderer_tpu_torch import Camera, generate_rays

    rays = generate_rays(Camera(width=16, height=8), device="cpu")
    Z, Y, X = VOL_SHAPE
    return dict(vol_u8=torch.from_numpy(_volume_u8()), entry_uv=rays.entry_uv,
                dir_step=(rays.direction * step_sizes((X, Y, Z), "cpu")).contiguous(),
                hit=rays.hit.to(torch.uint8))


def test_wrapper_cpu_runs_plain_version():
    before = RK.composite_march_cuda.launches
    kw = _wrapper_inputs()
    c, a = RK.composite_march_cuda(**kw, max_samples=16)
    ref = composite_march_steps(as_normalized_volume(kw["vol_u8"]), kw["entry_uv"],
                                kw["dir_step"], kw["hit"].bool(), 16)
    assert torch.equal(c, ref[0]) and torch.equal(a, ref[1])
    assert RK.composite_march_cuda.launches == before  # no kernel launched on CPU


@pytest.mark.parametrize("field,value,match", [
    ("vol_u8", lambda kw: kw["vol_u8"].float(), "uint8"),
    ("vol_u8", lambda kw: kw["vol_u8"][0], "uint8"),
    ("vol_u8", lambda kw: kw["vol_u8"].transpose(0, 2), "contiguous"),
    ("entry_uv", lambda kw: kw["entry_uv"].double(), "float32"),
    ("entry_uv", lambda kw: kw["entry_uv"][:, :-1].contiguous(), "float32"),
    ("dir_step", lambda kw: kw["dir_step"].reshape(-1, 3), "float32"),
    ("hit", lambda kw: kw["hit"].bool(), "uint8"),
    ("hit", lambda kw: kw["hit"].reshape(-1), "uint8"),
    ("hit", lambda kw: kw["hit"].numpy(), "torch.Tensor"),
])
def test_wrapper_rejects_bad_inputs(field, value, match):
    kw = _wrapper_inputs()
    kw[field] = value(kw)
    with pytest.raises((ValueError, TypeError), match=match):
        RK.composite_march_cuda(**kw)


@pytest.mark.parametrize("kwargs,match", [
    (dict(max_samples=-1), "max_samples"),
    (dict(max_samples=2.5), "max_samples"),
    (dict(wrap="mirror"), "wrap"),
])
def test_wrapper_rejects_bad_arguments(kwargs, match):
    with pytest.raises(ValueError, match=match):
        RK.composite_march_cuda(**_wrapper_inputs(), **kwargs)


def test_plan_rejects_mismatched_volume():
    kw = _wrapper_inputs()
    plan = RK.CompositingPlan(kw["entry_uv"], kw["dir_step"], kw["hit"], (128, 16, 8))
    with pytest.raises(ValueError, match="does not match"):
        plan.render(torch.zeros(8, 16, 64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_kernel_matches_plain_on_cuda(cuda_device, wrap):
    """The CUDA kernel vs the plain march on the same card and inputs."""
    from volumerenderer_tpu_torch import Camera, generate_rays
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume

    vol_u8 = torch.from_numpy(turbulence_volume((64, 48, 96), seed=1)).to(cuda_device)
    rays = generate_rays(Camera(width=96, height=64, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device=cuda_device)
    Z, Y, X = vol_u8.shape
    dir_step = (rays.direction * step_sizes((X, Y, Z), cuda_device)).contiguous()
    hit = rays.hit.to(torch.uint8)
    before = RK.composite_march_cuda.launches
    c_k, a_k = RK.composite_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, wrap=wrap)
    torch.cuda.synchronize()
    assert RK.composite_march_cuda.launches == before + 1
    c_p, a_p = composite_march_steps(as_normalized_volume(vol_u8), rays.entry_uv, dir_step,
                                     rays.hit, wrap=wrap)
    assert float(a_p.max()) > 0.5
    # a 1-ulp difference at the 0.99 early-out costs one composite step
    # (pa <= 0.01); allow a handful of such pixels, none larger
    for k, p in ((c_k, c_p), (a_k, a_p)):
        d = (k - p).abs()
        assert float(d.max()) <= 1.5e-2
        assert int((d > 1e-5).sum()) <= 4


@pytest.mark.cuda
def test_kernel_goldens_on_cuda(cuda_device):
    """The pins of tests/test_goldens.py, through the kernel."""
    from volumerenderer_tpu_torch import Camera, generate_rays
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
    from volumerenderer_tpu_torch.models import plan_compositing

    vol = as_normalized_volume(turbulence_volume((32, 32, 32), seed=99), device=cuda_device)
    rays = generate_rays(Camera(width=64, height=48), device=cuda_device)
    before = RK.composite_march_f32_cuda.launches  # render: B1 on the float32 volume
    rgb, a = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (32, 32, 32)).render(vol)
    assert RK.composite_march_f32_cuda.launches == before + 1
    assert abs(float(rgb.sum()) - 3667.208252) < 0.02
    assert abs(float(a.sum()) - 3046.968750) < 0.02


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices_on_cuda(cuda_device):
    kw = _wrapper_inputs()
    kw["vol_u8"] = kw["vol_u8"].to(cuda_device)
    with pytest.raises(ValueError, match="is on cpu"):
        RK.composite_march_cuda(**kw)

