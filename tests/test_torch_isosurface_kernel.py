"""The port's isosurface wrappers and ``IsosurfacePlan``.

On CPU tensors the wrappers run the plain PyTorch march and shade; the plan
is held against the JAX package's ``IsosurfacePlan`` with ``bind``, its Pallas
kernels run in interpret mode as tests/test_pallas_interpret.py runs them:
equal hit masks, rgb within that file's 2e-3, and the march's ``t_hit``
equal to the TPU kernel's.  The kernels themselves run only where there is
a CUDA device: the ``cuda``-marked tests hold them against the plain versions
there.

The machine with the card has no JAX, so this file imports JAX only inside
the tests that compare with it; there the card's tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_isosurface_kernel.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import as_normalized_volume
from volumerenderer_tpu_torch.interop import rays_from_numpy
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import quantize_u8
from volumerenderer_tpu_torch.ops.isosurface import (iso_march_steps, render_isosurface,
                                                     shade_hits)
from volumerenderer_tpu_torch.ops.raycast import step_sizes

VOL_SHAPE = (8, 16, 128)  # (Z, Y, X), the interpret-mode tests' volume


def _sphere_u8():
    return sphere_volume(VOL_SHAPE, radius=0.3, soft=0.2)


def _jax_rays(width=64, height=32):
    import volumerenderer_tpu as J

    rays = J.generate_rays(J.Camera(width=width, height=height))
    return tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


def test_plan_matches_jax_pallas_plan():
    from jax.experimental.pallas import tpu as pltpu

    import volumerenderer_tpu as J
    from volumerenderer_tpu.ops.pallas import isosurface_kernel as JK
    from volumerenderer_tpu.ops.pallas.raycast_kernel import _untile
    from conftest import EAGER_INTERPRET

    vol_u8 = _sphere_u8()
    entry_uv, direction, hit = _jax_rays()
    Z, Y, X = VOL_SHAPE
    H, W = hit.shape
    iso = 0.5
    vol_j = J.as_normalized_volume(vol_u8)
    with pltpu.force_tpu_interpret_mode(EAGER_INTERPRET):
        plan_j = JK.IsosurfacePlan(entry_uv, direction, hit, (X, Y, Z), max_samples=24)
        assert plan_j.use_kernel and plan_j.group > 1
        words = plan_j.bind(vol_j, iso)
        assert plan_j.gwords is not None
        # the march IsosurfacePlan.render runs for a bound grouped plan
        found_tiles, t_hit_tiles = JK.march_phased(
            plan_j.rays_packed, words, plan_j.gwords, plan_j.state0, plan_j.texit, vol_j,
            np.full((1, 1), iso * 255.0, np.float32), plan_j.dims, plan_j.max_samples + 1,
            plan_j.win_z, plan_j.win_y, plan_j.group, plan_j.lanes, xwords=plan_j.xwords)
        rgb_j, found_j = plan_j.render(vol_j, iso, words=words)
    found_tpu = np.asarray(_untile(found_tiles, H, W, plan_j.lanes)) > 0.5
    t_hit_tpu = np.asarray(_untile(t_hit_tiles, H, W, plan_j.lanes)).astype(np.int32)

    rays = rays_from_numpy(entry_uv, direction, hit, device="cpu")
    plan_t = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z),
                               max_samples=24)
    vol_t = as_normalized_volume(vol_u8, device="cpu")
    rgb_t, found_t = plan_t.render(vol_t, iso)
    march_found, march_t_hit = IK.iso_march_cuda(quantize_u8(vol_t), plan_t.entry_uv,
                                                 plan_t.dir_step, plan_t.hit, iso,
                                                 plan_t.max_samples)

    assert rgb_t.shape == (H, W, 3) and found_t.shape == (H, W)
    assert int(found_t.sum()) > 100
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=2e-3, rtol=0)
    np.testing.assert_array_equal(march_found.numpy(), found_tpu)
    np.testing.assert_array_equal(march_t_hit.numpy(), t_hit_tpu)


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_render_isosurface_kernel_cpu_equals_plain(wrap):
    """On CPU the kernel entry point is the plain path on the 8-bit grid:
    equal to ``render_isosurface`` for a byte-derived volume."""
    vol = as_normalized_volume(turbulence_volume(VOL_SHAPE, seed=3), device="cpu")
    rays = rays_from_numpy(*_jax_rays(32, 16), device="cpu")
    iso = IK.volume_median(vol)
    got = IK.render_isosurface_kernel(vol, rays.entry_uv, rays.direction, rays.hit, iso,
                                      max_samples=40, wrap=wrap)
    ref = render_isosurface(vol, rays.entry_uv, rays.direction, rays.hit, iso,
                            max_samples=40, wrap=wrap)
    assert int(ref[1].sum()) > 0
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _march_inputs():
    from volumerenderer_tpu_torch import Camera, generate_rays

    rays = generate_rays(Camera(width=16, height=8), device="cpu")
    Z, Y, X = VOL_SHAPE
    return dict(vol_u8=torch.from_numpy(_sphere_u8()), entry_uv=rays.entry_uv,
                dir_step=(rays.direction * step_sizes((X, Y, Z), "cpu")).contiguous(),
                hit=rays.hit.to(torch.uint8))


def _shade_inputs():
    from volumerenderer_tpu_torch import Camera, generate_rays

    kw = _march_inputs()
    found, t_hit = IK.iso_march_cuda(**kw, iso=0.5)
    rays = generate_rays(Camera(width=16, height=8), device="cpu")
    return dict(vol_u8=kw["vol_u8"], entry_uv=kw["entry_uv"], dir_step=kw["dir_step"],
                direction=rays.direction, found=found, t_hit=t_hit)


def test_wrappers_cpu_run_plain_versions():
    before = (IK.iso_march_cuda.launches, IK.iso_shade_cuda.launches)
    kw = _march_inputs()
    vol = as_normalized_volume(kw["vol_u8"])
    found, t_hit = IK.iso_march_cuda(**kw, iso=0.5, max_samples=64)
    ref = iso_march_steps(vol, kw["entry_uv"], kw["dir_step"], kw["hit"].bool(), 0.5, 64)
    assert torch.equal(found, ref[0]) and torch.equal(t_hit, ref[1])
    assert int(found.sum()) > 0
    sk = _shade_inputs()
    rgb = IK.iso_shade_cuda(**sk, iso=0.5)
    assert torch.equal(rgb, shade_hits(vol, sk["entry_uv"], sk["dir_step"], sk["direction"],
                                       sk["found"], sk["t_hit"], 0.5))
    # no kernel launched on CPU
    assert (IK.iso_march_cuda.launches, IK.iso_shade_cuda.launches) == before


_BAD_COMMON = [
    ("vol_u8", lambda kw: kw["vol_u8"].float(), "uint8"),
    ("vol_u8", lambda kw: kw["vol_u8"][0], "uint8"),
    ("vol_u8", lambda kw: kw["vol_u8"].transpose(0, 2), "contiguous"),
    ("entry_uv", lambda kw: kw["entry_uv"].double(), "float32"),
    ("entry_uv", lambda kw: kw["entry_uv"][:, :-1].contiguous(), "float32"),
    ("dir_step", lambda kw: kw["dir_step"].reshape(-1, 3), "float32"),
    ("dir_step", lambda kw: kw["dir_step"].numpy(), "torch.Tensor"),
]


@pytest.mark.parametrize("field,value,match", _BAD_COMMON + [
    ("hit", lambda kw: kw["hit"].bool(), "uint8"),
    ("hit", lambda kw: kw["hit"].reshape(-1), "uint8"),
])
def test_march_wrapper_rejects_bad_inputs(field, value, match):
    kw = _march_inputs()
    kw[field] = value(kw)
    with pytest.raises((ValueError, TypeError), match=match):
        IK.iso_march_cuda(**kw, iso=0.5)


@pytest.mark.parametrize("field,value,match", _BAD_COMMON + [
    ("direction", lambda kw: kw["direction"].half(), "float32"),
    ("found", lambda kw: kw["found"].to(torch.uint8), "bool"),
    ("found", lambda kw: kw["found"].reshape(-1), "bool"),
    ("t_hit", lambda kw: kw["t_hit"].long(), "int32"),
    ("t_hit", lambda kw: kw["t_hit"][:-1].contiguous(), "int32"),
])
def test_shade_wrapper_rejects_bad_inputs(field, value, match):
    kw = _shade_inputs()
    kw[field] = value(kw)
    with pytest.raises((ValueError, TypeError), match=match):
        IK.iso_shade_cuda(**kw, iso=0.5)


@pytest.mark.parametrize("kwargs,match", [
    (dict(iso=float("nan")), "iso"),
    (dict(iso=True), "iso"),
    (dict(iso="0.5"), "iso"),
    (dict(iso=0.5, max_samples=-1), "max_samples"),
    (dict(iso=0.5, max_samples=2.5), "max_samples"),
    (dict(iso=0.5, wrap="mirror"), "wrap"),
])
def test_march_wrapper_rejects_bad_arguments(kwargs, match):
    with pytest.raises(ValueError, match=match):
        IK.iso_march_cuda(**_march_inputs(), **kwargs)


@pytest.mark.parametrize("kwargs,match", [
    (dict(iso=float("inf")), "iso"),
    (dict(iso=0.5, wrap="mirror"), "wrap"),
])
def test_shade_wrapper_rejects_bad_arguments(kwargs, match):
    with pytest.raises(ValueError, match=match):
        IK.iso_shade_cuda(**_shade_inputs(), **kwargs)


def test_plan_rejects_mismatched_volume():
    kw = _march_inputs()
    plan = IK.IsosurfacePlan(kw["entry_uv"], kw["dir_step"], kw["hit"], (128, 16, 8))
    with pytest.raises(ValueError, match="does not match"):
        plan.render(torch.zeros(8, 16, 64))


def test_volume_median_rejects_empty():
    with pytest.raises(ValueError, match="empty"):
        IK.volume_median(torch.zeros(0, 4, 4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_scene(device, iso_kind):
    from volumerenderer_tpu_torch import Camera, generate_rays

    vol_u8 = torch.from_numpy(turbulence_volume((64, 48, 96), seed=1)).to(device)
    rays = generate_rays(Camera(width=96, height=64, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device=device)
    Z, Y, X = vol_u8.shape
    dir_step = (rays.direction * step_sizes((X, Y, Z), device)).contiguous()
    vol = as_normalized_volume(vol_u8)
    iso = IK.volume_median(vol) if iso_kind == "median" else 40.0 / 255.0
    return vol_u8, vol, rays, dir_step, iso


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("iso_kind", ["median", "40/255"])
def test_kernels_match_plain_on_cuda(cuda_device, wrap, iso_kind):
    """Both CUDA kernels vs the plain march and shade on the same card and
    inputs; the shade pass of each is fed the kernel march's output."""
    vol_u8, vol, rays, dir_step, iso = _card_scene(cuda_device, iso_kind)
    hit = rays.hit.to(torch.uint8)
    before = (IK.iso_march_cuda.launches, IK.iso_shade_cuda.launches)
    found_k, t_hit_k = IK.iso_march_cuda(vol_u8, rays.entry_uv, dir_step, hit, iso, wrap=wrap)
    rgb_k = IK.iso_shade_cuda(vol_u8, rays.entry_uv, dir_step, rays.direction, found_k,
                              t_hit_k, iso, wrap)
    torch.cuda.synchronize()
    assert (IK.iso_march_cuda.launches, IK.iso_shade_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    found_p, t_hit_p = iso_march_steps(vol, rays.entry_uv, dir_step, rays.hit, iso, wrap=wrap)
    rgb_p = shade_hits(vol, rays.entry_uv, dir_step, rays.direction, found_k, t_hit_k, iso,
                       wrap)
    assert int(found_p.sum()) > 0
    assert torch.equal(found_k, found_p) and torch.equal(t_hit_k, t_hit_p)
    assert float((rgb_k - rgb_p).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_iso_golden_on_cuda(cuda_device):
    """The isosurface pin of tests/test_goldens.py, through both kernels."""
    from volumerenderer_tpu_torch import Camera, generate_rays

    vol = as_normalized_volume(turbulence_volume((32, 32, 32), seed=99), device=cuda_device)
    rays = generate_rays(Camera(width=64, height=48), device=cuda_device)
    before = (IK.iso_march_cuda.launches, IK.iso_shade_cuda.launches)
    plan = IK.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, (32, 32, 32))
    rgb, found = plan.render(vol)
    assert (IK.iso_march_cuda.launches, IK.iso_shade_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    assert abs(float(rgb.sum()) - 9185.606445) < 0.05
    assert int(found.sum()) == 18


@pytest.mark.cuda
def test_wrappers_reject_mixed_devices_on_cuda(cuda_device):
    kw = _march_inputs()
    kw["vol_u8"] = kw["vol_u8"].to(cuda_device)
    with pytest.raises(ValueError, match="is on cpu"):
        IK.iso_march_cuda(**kw, iso=0.5)
    sk = _shade_inputs()
    sk["found"] = sk["found"].to(cuda_device)
    with pytest.raises(ValueError, match="is on cuda"):
        IK.iso_shade_cuda(**sk, iso=0.5)
