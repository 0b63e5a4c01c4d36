"""The port's spans (``utils/timer.py::span``) on the paths the benchmark's
cells run.  Under ``torch.profiler.profile`` on the CPU each call gives
exactly its ``vr.`` spans, once each, nested as its work is: the iso bind
(``vr.iso.bind``, its grid build ``vr.grid`` inside, and no ``vr.grid``
where the bind reuses the grid of data bound before), the iso render, the
compositing bind and render, and a fit step through ``make_render_tf_voxel``
(``vr.tf.march``; ``vr.voxel_grad`` with ``vr.voxel_grad.quantize``
inside), the slab pool's build (``vr.pool.build``), the pooled compositing
render (``vr.composite.render_pooled``) and a kd-tree's cut decode
(``vr.kd.decode``).  With no profiler active, ``span`` is one shared no-op and never
reaches ``record_function``.  Images, grids, losses and gradients are bit
for bit the same with the profiler on and off.  The benchmark's four
readers of the spans (``benchmark/metrics/``) read a traced window of iso
frames (binding new data each frame, or one volume each frame) and fit
steps, and read nothing from a program without spans."""
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.codecs import device as TD
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.diff.transfer import TFParams
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.cuda.isosurface_kernel import IsosurfacePlan
from volumerenderer_tpu_torch.ops.cuda.voxel_grad_kernel import make_render_tf_voxel
from volumerenderer_tpu_torch.utils import timer as TT

BENCH_DIR = Path(__file__).resolve().parent.parent / "benchmark"
SHAPE = (24, 20, 28)  # (Z, Y, X): Z a multiple of 8 for the slab pool, Y and X not
ISO = 0.45


@pytest.fixture(scope="module")
def scene():
    vol = as_normalized_volume(turbulence_volume(SHAPE, seed=3), device="cpu")
    rays = generate_rays(Camera(width=24, height=20, position=(0.3, 0.1, -0.7),
                                front=(-0.3, -0.1, 0.7)), device="cpu")
    Z, Y, X = SHAPE
    args = (rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))
    iso, comp = IsosurfacePlan(*args, max_samples=64), RK.CompositingPlan(*args, max_samples=64)
    dtree, spec = TD.to_device(TK.build(turbulence_volume((8, 8, 16), seed=4), tolerance=2,
                                        max_epochs=2), "cpu")
    return types.SimpleNamespace(vol=vol, iso=iso, comp=comp, bound=iso.bind(vol, ISO),
                                 target=torch.full((20, 24, 3), 0.5),
                                 pool=RK.build_slab_pool(RK.quantize_u8(vol)), dtree=dtree,
                                 spec=spec)


def _fit_step(s):
    f = make_render_tf_voxel(s.comp)
    leaves = [p.clone().requires_grad_(True) for p in TFParams.reference("cpu")]
    vol = s.vol.clone().requires_grad_(True)
    rgb, _ = f(TFParams(*leaves), vol)
    loss = torch.mean((rgb - s.target) ** 2)
    return (loss.detach(), *torch.autograd.grad(loss, [*leaves, vol]))


# each call, and its spans: name -> the span it lies inside (None: no vr. span)
CALLS = {
    "iso_bind": (lambda s: s.iso.bind(s.vol.clone(), ISO).grid,
                 {"vr.iso.bind": None, "vr.grid": "vr.iso.bind"}),
    # the volume the scene bound, unchanged since: its grid reused, not built
    "iso_bind_reused": (lambda s: s.iso.bind(s.vol, ISO).grid, {"vr.iso.bind": None}),
    "iso_bind_mip8": (lambda s: s.iso.bind(s.vol, ISO, mip8=RK.block_max8(s.vol)).grid,
                      {"vr.iso.bind": None, "vr.grid": "vr.iso.bind"}),
    "iso_bind_pool": (lambda s: s.iso.bind(pool=RK.build_slab_pool(RK.quantize_u8(s.vol)),
                                           iso_value=ISO).grid,
                      {"vr.pool.build": None, "vr.iso.bind": None,
                       "vr.grid": "vr.iso.bind"}),
    "iso_render": (lambda s: s.iso.render(s.vol, ISO, bound=s.bound),
                   {"vr.iso.render": None}),
    "composite_bind": (lambda s: s.comp.bind(s.vol.clone()).grid, {"vr.grid": None}),
    "composite_render": (lambda s: s.comp.render(s.vol), {"vr.composite.render": None}),
    "pool_build": (lambda s: RK.build_slab_pool(RK.quantize_u8(s.vol)),
                   {"vr.pool.build": None}),
    "composite_render_pooled": (lambda s: s.comp.render_pooled(*s.pool),
                                {"vr.composite.render_pooled": None}),
    "kd_decode": (lambda s: TD.level_cut_device(s.dtree, s.spec), {"vr.kd.decode": None}),
    "fit_step": (_fit_step, {"vr.tf.march": None, "vr.voxel_grad": None,
                             "vr.voxel_grad.quantize": "vr.voxel_grad"}),
}


def _profiled(fn):
    """fn's result and its ``vr.`` spans: name -> (start, end, thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [e for e in prof.events() if e.name.startswith("vr.")]
    names = sorted(e.name for e in spans)
    assert names == sorted(set(names)), f"a span recorded more than once: {names}"
    return out, {e.name: (e.time_range.start, e.time_range.end, e.thread) for e in spans}


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1] and inner[2] == outer[2]


@pytest.mark.parametrize("call", sorted(CALLS))
def test_each_call_gives_its_spans_once_nested(scene, call):
    fn, want = CALLS[call]
    _, spans = _profiled(lambda: fn(scene))
    assert sorted(spans) == sorted(want)
    for name, parent in want.items():
        if parent is not None:
            assert _inside(spans[name], spans[parent]), (name, spans)
        else:
            assert not any(_inside(spans[name], v) for k, v in spans.items() if k != name)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_outputs_are_bit_identical_with_the_profiler_on_and_off(scene, call):
    fn = CALLS[call][0]
    off = fn(scene)
    on, spans = _profiled(lambda: fn(scene))
    assert spans
    off, on = (x if isinstance(x, tuple) else (x,) for x in (off, on))
    assert len(off) == len(on) and all(torch.equal(a, b) for a, b in zip(off, on))


def test_span_without_a_profiler_is_one_shared_no_op(scene, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler active")

    monkeypatch.setattr(TT, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = TT.span("vr.a")
    assert first is TT.span("vr.b")
    with first:
        pass
    for fn, _ in CALLS.values():  # every spanned path, none reaching record_function
        fn(scene)


def _readers():
    from vrbench import harness

    names = ("grid_ms.iso", "grid_builds.iso", "program_host_ms.iso", "quantize_ms.fit")
    return {n: harness.reader(n, BENCH_DIR) for n in names}


def _traced_window(tmp_path, frame, frames):
    """A window of ``frames`` calls of ``frame``, traced as the benchmark
    traces one (a ``window`` range, each call in a ``frame`` range), read
    back through the benchmark's ``Trace``."""
    from vrbench import tracing

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame()
        with record_function("window"):
            for _ in range(frames):
                with record_function("frame"):
                    frame()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return types.SimpleNamespace(trace=tracing.load(path, frames))


@pytest.mark.parametrize("spans_on", [True, False], ids=["program", "without_spans"])
def test_benchmark_readers_read_the_spans(scene, tmp_path, monkeypatch, spans_on):
    monkeypatch.syspath_prepend(str(BENCH_DIR))
    if not spans_on:  # the program as it was before its spans
        monkeypatch.setattr(TT, "_profiler_enabled", lambda: False)
    read = _readers()

    def iso_frame(vol):
        return scene.iso.render(vol, ISO, bound=scene.iso.bind(vol, ISO))

    # new data each frame (a clone: a build a frame), then the one volume
    # the scene bound (the grid reused: no build)
    iso = _traced_window(tmp_path, lambda: iso_frame(scene.vol.clone()), 3)
    reused = _traced_window(tmp_path, lambda: iso_frame(scene.vol), 3)
    fit = _traced_window(tmp_path, lambda: _fit_step(scene), 2)
    got = {n: read[n](fit if n.endswith(".fit") else iso) for n in read}
    got_reused = {n: read[n](reused) for n in read if n.endswith(".iso")}
    if not spans_on:
        assert got == dict.fromkeys(read) and got_reused == dict.fromkeys(got_reused)
        return
    assert got["grid_builds.iso"] == 1.0
    assert got_reused["grid_builds.iso"] == 0.0 and got_reused["grid_ms.iso"] == 0.0
    assert got_reused["program_host_ms.iso"] > 0.0
    assert got["program_host_ms.iso"] > 0.0
    # no device here: the card's time inside the spans is 0
    assert got["grid_ms.iso"] == 0.0 and got["quantize_ms.fit"] == 0.0
