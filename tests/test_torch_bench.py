"""The port's bench (``volumerenderer_tpu_torch/bench.py``) against
``bench.py``: the orbit, each sweep's scalar, the five metric lines.

Small sizes on the CPU, where every wrapper runs its plain version: a 32^3
``turbulence_volume(seed=0)``, 3 orbit frames of 32x24, JAX's rays carried
over with ``interop.rays_from_numpy``.  Bars, per value summed: compositing
and the pooled marches 6e-7 of JAX's ``render_compositing``
(``docs/PARITY.md``), and the two pooled scalars bit-equal to the dense one;
the isosurface 1e-4 of JAX's ``render_isosurface`` (the specular
``pow(x, 250)``, tests/test_torch_iso_slice.py), bound bit-equal to
unbound; the voxel step rtol 2e-3 of the JAX chain of
tests/test_torch_grad_slice.py; the orbit's rays 1e-6 of JAX's with an equal
hit mask (tests/test_torch_camera.py).

The machine with the card has no JAX, so this file imports JAX only inside
the tests that compare with it; there the card's tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_bench.py``.
"""
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import TFParams, as_normalized_volume, bench as TB, generate_rays
from volumerenderer_tpu_torch.interop import rays_from_numpy
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.models import plan_compositing
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.cuda.voxel_grad_kernel import make_render_tf_voxel
from volumerenderer_tpu_torch.ops.isosurface import render_isosurface
from volumerenderer_tpu_torch.ops.raycast import apply_reference_transfer, composite_march_steps

REPO = Path(__file__).resolve().parents[1]
SHAPE, W, H, N = (32, 32, 32), 32, 24, 3
COMP_BAR, ISO_BAR, RAY_BAR, STEP_RTOL = 6e-7, 1e-4, 1e-6, 2e-3
METRICS = [TB.ISO_METRIC, *TB.POOLED_METRICS.values(), TB.VOXEL_METRIC, TB.HEADLINE]


def _plans(bundles, dims):
    plans = [plan_compositing(r.entry_uv, r.direction, r.hit, dims) for r in bundles]
    iso_plans = [IK.IsosurfacePlan(r.entry_uv, r.direction, r.hit, dims) for r in bundles]
    return plans, iso_plans


@pytest.fixture(scope="module")
def jax_scene():
    """The port's volume and plans from JAX's rays, and JAX's renders of
    them: the compositing and isosurface frames, the voxel step's scalar."""
    import jax
    import jax.numpy as jnp
    import volumerenderer_tpu as J
    import bench as jbench
    from volumerenderer_tpu.diff.transfer import TFParams as JTFParams
    from volumerenderer_tpu.diff.vjp import render_tf_o1
    from volumerenderer_tpu.io.synthetic import turbulence_volume as turbulence_volume_jax

    vol_u8 = turbulence_volume(SHAPE, seed=0)
    np.testing.assert_array_equal(vol_u8, turbulence_volume_jax(SHAPE, seed=0))
    vol_j = J.as_normalized_volume(vol_u8)
    rays_j = [(r.entry_uv, r.direction, r.hit) for r in
              (J.generate_rays(jbench.orbit_camera(2.0 * i, W, H)) for i in range(N))]
    rays_np = [tuple(np.asarray(a) for a in r) for r in rays_j]
    iso = float(jnp.median(vol_j))
    comp_j = [np.asarray(J.render_compositing(vol_j, *r)[0], np.float64) for r in rays_j]
    iso_j = [np.asarray(J.render_isosurface(vol_j, *r, iso_value=iso)[0], np.float64)
             for r in rays_j]
    target = jnp.full((H, W, 3), 0.5, jnp.float32)

    def loss(p, v):
        rgb, _ = render_tf_o1(p, v, *rays_j[0])
        return jnp.mean((rgb - target) ** 2)

    gp, gv = jax.grad(loss, argnums=(0, 1))(JTFParams.reference(), vol_j)
    vol = as_normalized_volume(vol_u8, device="cpu")
    plans, iso_plans = _plans([rays_from_numpy(*r, device="cpu") for r in rays_np],
                              SHAPE[::-1])
    return {"vol": vol, "plans": plans, "iso_plans": iso_plans, "iso": iso,
            "comp_j": comp_j, "iso_j": iso_j,
            "step_j": float(gp.alpha_scale + jnp.sum(gv))}


@pytest.mark.parametrize("az_deg", [0.0, 2.0, 30.0])
def test_orbit_camera_rays_match_jax(az_deg):
    import volumerenderer_tpu as J
    import bench as jbench

    cam_j, cam_t = jbench.orbit_camera(az_deg, 64, 48), TB.orbit_camera(az_deg, 64, 48)
    assert dataclasses.asdict(cam_t) == dataclasses.asdict(cam_j)
    rj = J.generate_rays(cam_j)
    rt = generate_rays(cam_t, device="cpu")
    assert np.asarray(rj.hit).any()
    np.testing.assert_allclose(rt.entry_uv.numpy(), np.asarray(rj.entry_uv), atol=RAY_BAR, rtol=0)
    np.testing.assert_allclose(rt.direction.numpy(), np.asarray(rj.direction), atol=RAY_BAR,
                               rtol=0)
    np.testing.assert_array_equal(rt.hit.numpy(), np.asarray(rj.hit))


@pytest.mark.parametrize("route", ["compositing", "narrow", "pair16"])
def test_compositing_sweeps_match_jax(jax_scene, route):
    """Σ rgb over the orbit within 6e-7 per value of JAX's frames; the
    pooled sweeps equal the dense one bit for bit."""
    vol, plans = jax_scene["vol"], jax_scene["plans"]
    dense = float(TB.sweep_compositing(vol, plans))
    if route == "compositing":
        value = dense
    else:
        build = RK.build_slab_pool_narrow if route == "narrow" else RK.build_slab_pool
        value = float(TB.sweep_pooled(*build(vol), plans))
        assert value == dense
    ref = sum(f.sum() for f in jax_scene["comp_j"])
    n_values = sum(f.size for f in jax_scene["comp_j"])
    assert abs(value - ref) <= COMP_BAR * n_values, (value, ref)
    frame = float(TB.forward_frame(plans[0], vol))
    assert abs(frame - jax_scene["comp_j"][0].sum()) <= COMP_BAR * jax_scene["comp_j"][0].size


def test_isosurface_sweep_matches_jax(jax_scene):
    """The isovalue is ``jnp.median``'s; Σ rgb within 1e-4 per value of
    JAX's frames, bound (one bind per plan) equal to unbound."""
    vol, plans = jax_scene["vol"], jax_scene["iso_plans"]
    iso = IK.volume_median(vol)
    assert iso == jax_scene["iso"]
    bound = float(TB.sweep_isosurface(vol, plans, iso, [p.bind(vol, iso) for p in plans]))
    unbound = float(TB.sweep_isosurface(vol, plans, iso, [None] * len(plans)))
    assert bound == unbound
    ref = sum(f.sum() for f in jax_scene["iso_j"])
    n_values = sum(f.size for f in jax_scene["iso_j"])
    assert abs(bound - ref) <= ISO_BAR * n_values, (bound, ref)


def test_voxel_grad_step_matches_jax(jax_scene):
    """``d alpha_scale + Σ dvolume`` of one step on orbit frame 0 within
    rtol 2e-3 of the JAX chain; fresh leaves, so a second call gives the
    same scalar."""
    vol, plan = jax_scene["vol"], jax_scene["plans"][0]
    render = make_render_tf_voxel(plan)
    params = TFParams.reference("cpu")
    target = torch.full((H, W, 3), 0.5)
    first = float(TB.voxel_grad_step(render, params, vol, target))
    assert float(TB.voxel_grad_step(render, params, vol, target)) == first
    assert not vol.requires_grad and all(not t.requires_grad for t in params)
    np.testing.assert_allclose(first, jax_scene["step_j"], rtol=STEP_RTOL)


def _lines(text):
    lines = text.splitlines()
    metrics = [json.loads(ln) for ln in lines if not ln.startswith("#")]
    notes = [json.loads(ln[2:]) for ln in lines if ln.startswith("# {")]
    return lines, metrics, notes


def _run_small(capsys):
    rc = TB.run("cpu", shape=SHAPE, width=W, height=H, n_frames=N)
    return (rc, *_lines(capsys.readouterr().out))


def test_run_prints_the_five_metrics_in_order(capsys):
    rc, lines, metrics, notes = _run_small(capsys)
    assert rc == 0
    assert [m["metric"] for m in metrics] == METRICS and lines[-1] == json.dumps(metrics[-1])
    for m in metrics:
        assert set(m) == {"metric", "value", "unit", "vs_baseline"}
        assert math.isfinite(m["value"]) and m["value"] > 0
    voxel = metrics[3]
    assert voxel["unit"] == "forward-frames/step" and voxel["vs_baseline"] == 3.0 / voxel["value"]
    for m in metrics[:3] + metrics[4:]:
        assert m["unit"] == "rays/s"
        assert m["vs_baseline"] == m["value"] / TB.NOMINAL_BASELINE_RAYS_PER_S
    # the device first; each metric line after its own facts, the card's
    # time not measured on the CPU, no kernel launched
    assert lines[0].startswith("# {") and notes[0]["device"] == "cpu"
    for m in metrics:
        i = lines.index(json.dumps(m))
        note = json.loads(lines[i - 1][2:])
        assert note["metric"] == m["metric"]
        for part in (note["forward_frame"], note["step"]) if "step" in note else (note,):
            assert part["event_ms_per_frame"] == "not measured"
            assert part["renders"] == (TB.REPS + 1) * (1 if "step" in note else N)
            assert not any(part["launches"].values())
    assert notes[1]["iso"] == IK.volume_median(as_normalized_volume(turbulence_volume(SHAPE),
                                                                    device="cpu"))


@pytest.mark.parametrize("sub", ["bench_isosurface", "bench_pooled", "bench_voxel_grad"])
def test_failing_sub_bench_keeps_the_headline(capsys, monkeypatch, sub):
    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(TB, sub, boom)
    rc, lines, metrics, _ = _run_small(capsys)
    name = {"bench_isosurface": "isosurface", "bench_pooled": "pooled",
            "bench_voxel_grad": "voxel-grad"}[sub]
    assert rc == 1
    assert f"# {name} bench failed: RuntimeError('boom')" in lines
    assert metrics[-1]["metric"] == TB.HEADLINE and lines[-1] == json.dumps(metrics[-1])
    assert len(metrics) == (3 if sub == "bench_pooled" else 4)


def test_command_without_a_card_prints_no_metric():
    """``python3 -m volumerenderer_tpu_torch.bench`` where CUDA is not
    available: a non-zero status before any metric line."""
    proc = subprocess.run([sys.executable, "-m", "volumerenderer_tpu_torch.bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == "" and "is_available() is False" in proc.stderr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sweeps_on_the_card_match_their_plain_versions(cuda_device):
    """Each sweep through the kernels against the same sums of the plain
    versions on the card: compositing, pooled and the forward frame bit for
    bit, the isosurface within 1e-4 per value, the voxel step within rtol
    2e-3 of the same step on CPU tensors; one launch per frame."""
    shape, w, h, n = (64, 64, 64), 64, 48, 3
    vol = as_normalized_volume(turbulence_volume(shape, seed=0), device=cuda_device)
    bundles = [generate_rays(TB.orbit_camera(2.0 * i, w, h), device=cuda_device)
               for i in range(n)]
    plans, iso_plans = _plans(bundles, shape[::-1])
    plain_vol = as_normalized_volume(RK.quantize_u8(vol))
    for f in TB.KERNELS.values():
        f.launches = 0

    frames = []
    for p in plans:
        c, a = composite_march_steps(plain_vol, p.entry_uv, p.dir_step, p.hit.bool(),
                                     p.max_samples)
        frames.append(apply_reference_transfer(c, a))
    plain = torch.zeros((), device=cuda_device)
    for rgb in frames:
        plain = plain + rgb.sum()
    assert float(TB.sweep_compositing(vol, plans)) == float(plain)
    assert float(TB.forward_frame(plans[0], vol)) == float(frames[0].sum())
    for build in (RK.build_slab_pool_narrow, RK.build_slab_pool):
        assert float(TB.sweep_pooled(*build(vol), plans)) == float(plain)

    iso = IK.volume_median(vol)
    swept = float(TB.sweep_isosurface(vol, iso_plans, iso, [p.bind(vol, iso) for p in iso_plans]))
    plain_iso = torch.zeros((), device=cuda_device)
    for r in bundles:
        plain_iso = plain_iso + render_isosurface(plain_vol, r.entry_uv, r.direction, r.hit,
                                                  iso)[0].sum()
    assert abs(swept - float(plain_iso)) <= ISO_BAR * n * h * w * 3

    target = torch.full((h, w, 3), 0.5, device=cuda_device)
    step = float(TB.voxel_grad_step(make_render_tf_voxel(plans[0]),
                                    TFParams.reference(cuda_device), vol, target))
    cpu_plan = plan_compositing(*(t.cpu() for t in (bundles[0].entry_uv, bundles[0].direction,
                                                     bundles[0].hit)), shape[::-1])
    cpu_step = float(TB.voxel_grad_step(make_render_tf_voxel(cpu_plan), TFParams.reference("cpu"),
                                        vol.cpu(), target.cpu()))
    np.testing.assert_allclose(step, cpu_step, rtol=STEP_RTOL)
    assert {k: f.launches for k, f in TB.KERNELS.items()} == {
        "composite_march": n + 1, "iso_march": n, "iso_shade": n,
        "composite_march_pooled_narrow": n, "composite_march_pooled_pair16": n,
        "tf_march": 1, "voxel_grad": 1}
