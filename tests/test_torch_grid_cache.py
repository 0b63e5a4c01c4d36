"""The reuse of a bind's block grid (``ops/cuda/blockgrid_kernel.py::bind_grid``):
a bind of the very tensors bound before, unchanged since, hands back the
grid it built, without a build (no ``vr.grid`` span, ``bind_grid.hits`` up
by one); new data, data written in place (directly or through a view), a
clone with equal bytes, another wrap or another route (bytes, mip8, pool)
builds its own.  The cache holds its data weakly, every reused grid equals
a fresh ``iso_block_grid`` of the data, and every bound render is bit-equal
to one from a fresh bind.  The ``cuda``-marked tests hold the same on the
card, where a reuse launches no grid kernel:
``python3 -m pytest --noconftest -m cuda tests/test_torch_grid_cache.py``.
"""
import gc
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.ops.blockgrid import (iso_block_grid, iso_grid_from_mip8,
                                                     iso_grid_from_pool)
from volumerenderer_tpu_torch.ops.cuda import blockgrid_kernel as GK
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK

SHAPE = (24, 20, 28)  # (Z, Y, X): Z a multiple of 8 for the slab pool


def _volume(dtype="float32", device="cpu", seed=3):
    vol_u8 = torch.from_numpy(turbulence_volume(SHAPE, seed=seed)).to(device)
    return vol_u8 if dtype == "uint8" else as_normalized_volume(vol_u8)


def _plan(kind="iso", wrap="clamp", device="cpu", camera=None):
    Z, Y, X = SHAPE
    rays = generate_rays(Camera(width=24, height=20, **(camera or {})), device=device)
    cls = IK.IsosurfacePlan if kind == "iso" else RK.CompositingPlan
    return cls(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), max_samples=64, wrap=wrap)


def _bind(plan, *args, **kwargs):
    if isinstance(plan, IK.IsosurfacePlan):
        kwargs.setdefault("iso_value", 0.45)
    return plan.bind(*args, **kwargs)


def _counts():
    return GK.bind_grid.builds, GK.bind_grid.hits


def _grid_spans(fn):
    """fn's result and the names of the ``vr.`` spans it recorded."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name for e in prof.events() if e.name.startswith("vr.")]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
@pytest.mark.parametrize("kind", ["iso", "composite"])
def test_a_second_bind_of_unchanged_data_builds_nothing(kind, wrap, dtype):
    vol = _volume(dtype)
    plan = _plan(kind, wrap)
    builds, hits = _counts()
    first = _bind(plan, vol, iso_value=0.3) if kind == "iso" else _bind(plan, vol)
    assert _counts() == (builds + 1, hits)
    again, spans = _grid_spans(lambda: _bind(plan, vol, iso_value=0.6) if kind == "iso"
                               else _bind(plan, vol))
    assert _counts() == (builds + 1, hits + 1)
    assert "vr.grid" not in spans
    assert spans == (["vr.iso.bind"] if kind == "iso" else [])
    assert again.grid is first.grid and again is not first
    assert torch.equal(again.grid, iso_block_grid(vol, wrap))
    if kind == "iso":
        assert (first.iso, again.iso) == (0.3, 0.6)
    assert again.source[0][0]() is vol and again.source[0][1] == vol._version


WRITES = {
    "mul_": lambda v: v.mul_(0.5),
    "copy_": lambda v: v.copy_(_volume(seed=11)),
    "view": lambda v: v[:, 3:9, ::2].fill_(1.0),
    "flat_view": lambda v: v.view(-1)[: v.numel() // 3].zero_(),
    "index_put": lambda v: v.__setitem__((slice(8, 16),), 0.0),
}


@pytest.mark.parametrize("kind", ["iso", "composite"])
@pytest.mark.parametrize("write", sorted(WRITES))
def test_a_write_in_place_rebuilds(write, kind):
    vol = _volume()
    plan = _plan(kind)
    old = _bind(plan, vol)
    WRITES[write](vol)
    want = iso_block_grid(vol)
    assert not torch.equal(want, old.grid)
    builds, hits = _counts()
    new, spans = _grid_spans(lambda: _bind(plan, vol))
    assert _counts() == (builds + 1, hits)
    assert "vr.grid" in spans
    assert torch.equal(new.grid, want) and new.grid is not old.grid
    # the new grid replaces the old: one entry for the volume, reused next
    assert len(GK._built[vol]) == 1
    assert _bind(plan, vol).grid is new.grid and _counts() == (builds + 1, hits + 1)
    # the old bound still refuses the written volume
    with pytest.raises(ValueError, match="other data"):
        plan.render(vol, 0.45, bound=old) if kind == "iso" else plan.render(vol, bound=old)


@pytest.mark.parametrize("clone", ["volume", "mip8", "pool", "slab_map"])
def test_a_clone_with_equal_bytes_builds_anew(clone):
    """Identity, not content: a bind with any of its tensors replaced by a
    clone of equal bytes builds, and its grid equals the first."""
    vol = _volume()
    mip = RK.block_max8(vol)
    pool, smap = RK.build_slab_pool(RK.quantize_u8(vol))
    plan = _plan()
    data = {"volume": vol, "mip8": mip, "pool": pool, "slab_map": smap}
    binds = {"volume": lambda d: _bind(plan, d["volume"]),
             "mip8": lambda d: _bind(plan, d["volume"], mip8=d["mip8"]),
             "pool": lambda d: _bind(plan, pool=(d["pool"], d["slab_map"])),
             "slab_map": lambda d: _bind(plan, pool=(d["pool"], d["slab_map"]))}
    bound = binds[clone](data)
    twin = dict(data, **{clone: data[clone].clone()})
    builds, hits = _counts()
    other = binds[clone](twin)
    assert _counts() == (builds + 1, hits)
    assert other.grid is not bound.grid and torch.equal(other.grid, bound.grid)
    if clone == "volume":
        with pytest.raises(ValueError, match="other data"):
            plan.render(twin["volume"], 0.45, bound=bound)


@pytest.mark.parametrize("first,second", [
    ("clamp", "repeat"), ("volume", "mip8"), ("mip8", "volume"), ("pool", "pool_mip8"),
    ("pool_mip8", "pool"),
])
def test_each_wrap_and_route_builds_its_own(first, second):
    """The bytes of a volume, its mip, a pool's bytes and a pool with a
    mip, and each wrap, are separate entries: each builds once, then each
    is reused, and each grid is that route's fresh grid."""
    vol = _volume()
    mip = RK.block_max8(vol)
    pool = RK.build_slab_pool(RK.quantize_u8(vol))
    plans = {w: _plan(wrap=w) for w in ("clamp", "repeat")}
    Z, Y, X = SHAPE
    routes = {
        "clamp": (lambda: _bind(plans["clamp"], vol), iso_block_grid(vol, "clamp")),
        "repeat": (lambda: _bind(plans["repeat"], vol), iso_block_grid(vol, "repeat")),
        "volume": (lambda: _bind(plans["clamp"], vol), iso_block_grid(vol)),
        "mip8": (lambda: _bind(plans["clamp"], vol, mip8=mip),
                 iso_grid_from_mip8(mip, (X, Y, Z))),
        "pool": (lambda: _bind(plans["clamp"], pool=pool), iso_block_grid(vol)),
        "pool_mip8": (lambda: _bind(plans["clamp"], pool=pool, mip8=mip),
                      iso_grid_from_mip8(mip, (X, Y, Z))),
    }
    builds, hits = _counts()
    grids = [routes[r][0]().grid for r in (first, second)]
    assert _counts() == (builds + 2, hits)
    assert grids[0] is not grids[1]
    for name, grid in zip((first, second), grids):
        assert torch.equal(grid, routes[name][1]), name
        assert routes[name][0]().grid is grid, name
    assert _counts() == (builds + 2, hits + 2)


def test_a_written_mip_or_slab_map_rebuilds():
    vol = _volume()
    mip = RK.block_max8(vol)
    pool, smap = RK.build_slab_pool(RK.quantize_u8(vol))
    plan = _plan()
    Z, Y, X = SHAPE
    for bind, write, want in (
            (lambda: _bind(plan, vol, mip8=mip), lambda: mip.mul_(0.25),
             lambda: iso_grid_from_mip8(mip, (X, Y, Z))),
            (lambda: _bind(plan, pool=(pool, smap)), lambda: smap.copy_(smap.flip(-1)),
             lambda: iso_grid_from_pool(pool, smap, (X, Y, Z)))):
        old = bind().grid
        write()
        builds, _ = _counts()
        new = bind().grid
        assert GK.bind_grid.builds == builds + 1
        assert torch.equal(new, want()) and not torch.equal(new, old)


def test_an_inference_mode_mip_always_builds():
    """A mip made under ``torch.inference_mode`` has no version counter, so
    no bind can tell it unchanged: each bind from it builds."""
    vol = _volume()
    with torch.inference_mode():
        mip = RK.block_max8(vol)
    plan = _plan()
    builds, hits = _counts()
    grids = [_bind(plan, vol, mip8=mip).grid for _ in range(2)]
    assert _counts() == (builds + 2, hits)
    assert torch.equal(grids[0], grids[1])


def test_a_written_grid_rebuilds():
    """The grid is shared by the bounds of one data: one written in place
    (through a bound) is not handed out again."""
    vol = _volume()
    plan = _plan()
    bound = _bind(plan, vol)
    bound.grid.zero_()
    builds, _ = _counts()
    again = _bind(plan, vol)
    assert GK.bind_grid.builds == builds + 1
    assert torch.equal(again.grid, iso_block_grid(vol))


@pytest.mark.parametrize("data", ["volume", "pool", "mip8"])
def test_the_cache_holds_its_data_weakly(data):
    vol = _volume()
    plan = _plan()
    pool = RK.build_slab_pool(RK.quantize_u8(vol))
    mip = RK.block_max8(vol)
    bound = {"volume": lambda: _bind(plan, vol), "pool": lambda: _bind(plan, pool=pool),
             "mip8": lambda: _bind(plan, vol, mip8=mip)}[data]()
    key = pool[0] if data == "pool" else vol
    assert key in GK._built
    refs = [weakref.ref(t) for t in (vol, mip, *pool)]
    gc.collect()
    n = len(GK._built)
    del vol, mip, pool, key
    gc.collect()
    assert all(r() is None for r in refs)
    assert len(GK._built) == n - 1
    # the bound keeps its grid, and no longer its data
    assert bound.grid.shape == (3, 3, 4, 2) and bound.source[0][0]() is None


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_a_bound_sweep_with_the_reused_grid_renders_as_fresh_binds(wrap):
    """An isovalue sweep on one volume, bound anew each frame (one build,
    then reuse), renders bit-equal to the same sweep with a fresh bind of a
    new tensor each frame and to the unbound sweep, on every camera."""
    vol = _volume()
    cameras = (None, dict(position=(0.3, 0.1, -0.7), front=(-0.3, -0.1, 0.7)))
    plans = [_plan(wrap=wrap, camera=c) for c in cameras]
    builds, hits = _counts()
    for i, iso in enumerate(40.0 / 255.0 + 25.0 / 255.0 * k for k in range(6)):
        plan = plans[i % len(plans)]
        reused = plan.render(vol, iso, bound=plan.bind(vol, iso))
        fresh_vol = vol.clone()
        fresh = plan.render(fresh_vol, iso, bound=plan.bind(fresh_vol, iso))
        unbound = plan.render(vol, iso)
        for got in (reused, fresh):
            assert torch.equal(got[0], unbound[0]) and torch.equal(got[1], unbound[1])
    assert GK.bind_grid.hits == hits + 5
    assert GK.bind_grid.builds == builds + 1 + 6


@pytest.mark.parametrize("volume", ["sphere", "turbulence"])
def test_a_compositing_bind_after_an_iso_bind_records_has_empty(volume):
    """An iso bind leaves ``has_empty`` True and does not decide it; the
    compositing bind that reuses its grid decides it once, as a fresh one
    does, and renders bit-equal to unbound."""
    vol_u8 = torch.from_numpy(sphere_volume(SHAPE, radius=0.25, soft=0.05) if volume == "sphere"
                              else turbulence_volume(SHAPE, seed=2) | 1)
    vol = as_normalized_volume(vol_u8)
    iso_bound = _bind(_plan(), vol)
    assert iso_bound.has_empty
    comp = _plan("composite")
    builds, hits = _counts()
    bound = comp.bind(vol)
    assert _counts() == (builds, hits + 1)
    assert bound.grid is iso_bound.grid
    assert bound.has_empty == (volume == "sphere") == comp.bind(vol.clone()).has_empty
    assert comp.bind(vol).has_empty == bound.has_empty
    want = comp.render(vol)
    got = comp.render(vol, bound=bound)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the grid kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_a_second_bind_launches_no_grid_kernel_on_cuda(cuda_device, dtype):
    """The second bind of one CUDA volume launches no grid kernel, and its
    bound B2 + B3 render is bit-equal to one from a fresh bind."""
    vol = _volume(dtype, cuda_device)
    plan = _plan(device=cuda_device)
    iso = IK.volume_median(_volume(device=cuda_device))  # on the normalized scale
    launches = GK.iso_block_grid_cuda.launches
    first = plan.bind(vol, 0.3)
    torch.cuda.synchronize()
    assert GK.iso_block_grid_cuda.launches == launches + 1
    again = plan.bind(vol, iso)
    torch.cuda.synchronize()
    assert GK.iso_block_grid_cuda.launches == launches + 1
    assert again.grid is first.grid and torch.equal(again.grid, iso_block_grid(vol))
    fresh_vol = vol.clone()
    fresh = plan.bind(fresh_vol, iso)
    assert GK.iso_block_grid_cuda.launches == launches + 2
    got = plan.render(vol, iso, bound=again)
    want = plan.render(fresh_vol, iso, bound=fresh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0 < int(got[1].sum())
    vol.mul_(1)
    plan.bind(vol, iso)
    torch.cuda.synchronize()
    assert GK.iso_block_grid_cuda.launches == launches + 3
