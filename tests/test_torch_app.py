"""The port's application layer against the JAX package's: ``app.run``
on a 16^3 turbulence at 24x16, 2 frames, ``device="cpu"``, in both render
modes with the kernel switch (``use_pallas_kernel``) on and off, against
JAX's ``run`` (which renders the same plain path either way).  Bars:
compositing frames within 6e-7; isosurface frames within 5e-3 at every
pixel (at 384 pixels, the 4 px per Mpixel allowed to differ round to none,
so hit masks agree); the metrics equal but ``frame_ms``; ``save_tree``
writes JAX's bytes; the camera-state machine equals JAX's float for float.
With the switch on, the frames come from the pooled plan: its wrappers run
their plain versions on CPU tensors."""
import dataclasses

import numpy as np
import pytest

from volumerenderer_tpu import app as JA
from volumerenderer_tpu import config as JCFG
from volumerenderer_tpu.camera import Camera as JCamera
from volumerenderer_tpu_torch import app as TA
from volumerenderer_tpu_torch import config as TCFG
from volumerenderer_tpu_torch.camera import Camera
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK

BARS = {"compositing": 6e-7, "isosurface": 5e-3}


def _cfg(mod, camera_cls, mode, tree_path="tree.bin", **render):
    return mod.AppConfig(
        render=mod.RenderConfig(camera=camera_cls(width=24, height=16), render_mode=mode,
                                max_samples=48, **render),
        codec=mod.CodecConfig(tolerance=2, max_epochs=1),
        dataset=mod.DatasetConfig(source="synthetic", synthetic_dims=(16, 16, 16)),
        tree_path=str(tree_path))


@pytest.fixture(scope="module", params=list(BARS))
def jax_run(request, tmp_path_factory):
    mode = request.param
    path = tmp_path_factory.mktemp("jax") / "tree.bin"
    frames, metrics = JA.run(_cfg(JCFG, JCamera, mode, path), num_frames=2, save_tree=True)
    return mode, [np.asarray(f) for f in frames], metrics.values, path


def _spy(monkeypatch, module, name, calls):
    original = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_run_equals_jax(jax_run, use_kernel, tmp_path, monkeypatch):
    mode, want, want_metrics, jax_tree = jax_run
    calls = {}
    for module, name in ((RK, "composite_march_pooled_pair16_cuda"),
                         (IK, "iso_march_pooled_narrow_cuda"), (IK, "iso_shade_pooled_cuda")):
        _spy(monkeypatch, module, name, calls)
    cfg = _cfg(TCFG, Camera, mode, tmp_path / "tree.bin", use_pallas_kernel=use_kernel)
    frames, metrics = TA.run(cfg, num_frames=2, save_tree=True, device="cpu")
    assert len(frames) == 2
    for got, ref in zip(frames, want):
        assert isinstance(got, np.ndarray) and got.shape == (16, 24, 3) == ref.shape
        np.testing.assert_allclose(got, ref, atol=BARS[mode], rtol=0)
    got_m = dict(metrics.values)
    assert set(got_m) == set(want_metrics)
    assert got_m.pop("frame_ms") > 0
    assert got_m == {k: v for k, v in want_metrics.items() if k != "frame_ms"}
    assert (tmp_path / "tree.bin").read_bytes() == jax_tree.read_bytes()
    if not use_kernel:
        assert calls == {}
    elif mode == "compositing":
        assert calls == {"composite_march_pooled_pair16_cuda": 2}
    else:
        assert calls == {"iso_march_pooled_narrow_cuda": 2, "iso_shade_pooled_cuda": 2}


def test_isosurface_marches_the_default_samples():
    """As in JAX's ``run``, ``max_samples`` reaches the compositing march
    only: the isosurface plan marches the reference's 300 samples."""
    cfg = _cfg(TCFG, Camera, "isosurface")
    plans = {}

    class Renderer:
        def make_plan(self, rays, cut, mode, **kw):
            plans[mode] = kw
            return lambda: None

    TA.frame_renderer(cfg, Renderer(), None)
    TA.frame_renderer(dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, render_mode="compositing")), Renderer(), None)
    assert plans == {"isosurface": {"iso_value": 40.0 / 255.0, "pooled": True},
                     "compositing": {"max_samples": 48, "pooled": True}}


def test_unknown_render_mode_raises():
    cfg = _cfg(TCFG, Camera, "volume")
    with pytest.raises(ValueError, match="render mode"):
        TA.frame_renderer(cfg, None, None)


def _walk(mod):
    st = mod.CameraState()
    out = [st]
    for step in (lambda s: mod.move(s, "up", dt=0.1), lambda s: mod.move(s, "left", dt=0.05),
                 lambda s: mod.look(s, dx=90.0, dy=0.0), lambda s: mod.move(s, "right", dt=0.2),
                 lambda s: mod.look(s, dx=-33.3, dy=12.5), lambda s: mod.move(s, "down", dt=0.3),
                 lambda s: mod.look(s, dx=0.0, dy=200.0), lambda s: mod.zoom(s, 10.0),
                 lambda s: mod.zoom(s, 100.0), lambda s: mod.zoom(s, -3.5),
                 lambda s: mod.step_isovalue(s, +1), lambda s: mod.step_isovalue(s, -1),
                 lambda s: mod.step_isovalue(s, +60), lambda s: mod.reset(s)):
        st = step(st)
        out.append(st)
    return out


def test_camera_state_machine_equals_jax():
    got, want = _walk(TA), _walk(JA)
    assert [f.name for f in dataclasses.fields(TA.CameraState)] == \
        [f.name for f in dataclasses.fields(JA.CameraState)]
    for a, b in zip(got, want):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert np.array_equal(np.asarray(x, np.float64), np.asarray(y, np.float64)), f.name
    # the same checks as tests/test_app.py
    st8 = got[-1]
    assert st8.position == (0.0, 0.0, -0.75) and st8.iso_value == 255.0
    cam = got[6].camera(32, 24)
    assert isinstance(cam, Camera) and cam.fov_y_degrees == got[6].fov
    assert dataclasses.asdict(cam) == dataclasses.asdict(want[6].camera(32, 24))


def test_run_rm_bricks_equals_jax(tmp_path):
    """``DatasetConfig(source="rm_bricks")``: 8 raw brick files of 8x8x4
    (the reference's layout ``bob<ttt>/d_<tttt>_<bbbb>``, written here from
    a seeded turbulence) loaded as a 2x2x2 grid, compressed and rendered as
    JAX's ``run`` does; the frames within the compositing bar."""
    from volumerenderer_tpu_torch.io.bricks import rm_brick_path
    from volumerenderer_tpu_torch.io.synthetic import turbulence_volume

    volume = turbulence_volume((8, 16, 16), seed=5)   # (Z, Y, X): 2x2x2 bricks of 8x8x4
    for b in range(8):
        i, j, k = b % 2, (b // 2) % 2, b // 4
        path = rm_brick_path(str(tmp_path), b, 273)
        (tmp_path / "bob273").mkdir(exist_ok=True)
        volume[4 * k:4 * k + 4, 8 * j:8 * j + 8, 8 * i:8 * i + 8].tofile(path)
    data = dict(source="rm_bricks", top_dir=str(tmp_path), brick_dims=(8, 8, 4),
                volume_grid=(2, 2, 2), num_bricks=8, load_grid=(2, 2, 2), timestep=273)

    def cfg(mod, camera_cls, **render):
        return mod.AppConfig(
            render=mod.RenderConfig(camera=camera_cls(width=24, height=16), max_samples=48,
                                    **render),
            codec=mod.CodecConfig(tolerance=2, max_epochs=1), dataset=mod.DatasetConfig(**data))

    np.testing.assert_array_equal(TA.load_volume(cfg(TCFG, Camera)), volume)
    want, want_m = JA.run(cfg(JCFG, JCamera))
    for use_kernel in (True, False):
        got, got_m = TA.run(cfg(TCFG, Camera, use_pallas_kernel=use_kernel), device="cpu")
        np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=BARS["compositing"], rtol=0)
        assert got_m.values["num_active_nodes"] == want_m.values["num_active_nodes"]
