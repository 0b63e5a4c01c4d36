"""The segment marches' entry table (``ops/raycast.py::seg_entry_table``,
``ops/cuda/seg_kernel.py::seg_entry_table_cuda``, ``csrc/seg_march.cu``)
and the marches started from it.

The table holds, per ray and shard, the first owned step index ``i0`` and
the position after ``i0`` additions.  It is held against a step-by-step
replay of the recurrence in numpy float32 (positions bit for bit, indices
equal).  The plain marches started from it are held against the walking
plain marches bit for bit, and against the JAX package's ``launch_seg`` in
interpret mode within the bars of tests/test_torch_seg_kernel.py.  The
``cuda``-marked tests hold the table kernel and the marches against their
plain versions on the card, bit for bit:
``python3 -m pytest --noconftest -m cuda tests/test_torch_seg_starts.py``.
"""
import numpy as np
import pytest
import torch

from test_torch_seg_kernel import NAMES, TF, _grazing_rays, _jax_segment, _slab, _volume_u8
from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.diff.closed_form import seg_tf_march_steps
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.models import plan_compositing
from volumerenderer_tpu_torch.ops.cuda import seg_kernel as SK
from volumerenderer_tpu_torch.ops.raycast import (BIG_T, NO_ENTRY, seg_entry_table,
                                                  seg_march_steps, step_sizes)
from volumerenderer_tpu_torch.ops.sampling import shard_sampler
from volumerenderer_tpu_torch.parallel import bricks, context, kernel_sharded as KS

CPU4 = [torch.device("cpu")] * 4


def _camera_rays(dims, camera, device="cpu"):
    rays = generate_rays(camera, device=device)
    dir_step = (rays.direction * step_sizes(dims, device)).contiguous()
    return rays.entry_uv, dir_step, rays.hit.to(torch.uint8)


FRONT = Camera(width=24, height=16)
OBLIQUE = Camera(width=24, height=16, position=(0.3, 0.1, -0.7), front=(-0.35, -0.1, 0.93))


def _scene(name):
    """(volume u8 (Z, Y, X), rays (entry_uv, dir_step, hit u8), max_samples)."""
    if name == "grazing":
        return _volume_u8((16, 16, 16), seed=9), _grazing_rays((16, 16, 16)), 40
    vol = turbulence_volume((32, 24, 40), seed=2)
    dims = (40, 24, 32)
    camera = FRONT if name == "front" else OBLIQUE
    return vol, _camera_rays(dims, camera), 20 if name == "cut_at_max_samples" else 300


def _shards(vol_u8, layout):
    """(z_lo, n_z, y_lo, n_y) of every shard of a 2-slab or 2x2-brick layout."""
    Z, Y, _ = vol_u8.shape
    if layout == "zslab":
        return [(0, Z // 2, 0, Y), (Z // 2, Z // 2, 0, Y)]
    return [(z, Z // 2, y, Y // 2) for z in (0, Z // 2) for y in (0, Y // 2)]


def _replay(entry, d, hit, dims, box, max_samples):
    """The table of one ray, one float32 operation at a time."""
    f32 = np.float32
    X, Y, Z = (f32(n) for n in dims)
    z_lo, z_hi, y_lo, y_hi = box
    p = entry.astype(f32)
    if hit:
        for i in range(max_samples):
            q = p + d
            if not ((q > 0) & (q < 1)).all():
                break
            z0 = min(max(np.floor(q[2] * Z - f32(0.5)), f32(0)), Z - f32(1))
            y0 = min(max(np.floor(q[1] * Y - f32(0.5)), f32(0)), Y - f32(1))
            if z_lo <= z0 < z_hi and y_lo <= y0 < y_hi:
                return p, i
            p = q
    return np.zeros(3, f32), NO_ENTRY


@pytest.mark.parametrize("scene", ["front", "oblique", "grazing", "cut_at_max_samples"])
def test_plain_table_equals_step_by_step_replay(scene):
    vol, (entry_uv, dir_step, hit), max_samples = _scene(scene)
    dims = vol.shape[::-1]
    for z_lo, n_z, y_lo, n_y in _shards(vol, "brick"):
        box = (z_lo, z_lo + n_z, y_lo, y_lo + n_y)
        table = seg_entry_table(entry_uv, dir_step, hit.bool(), dims, box, max_samples)
        assert table.shape == (*hit.shape, 4) and table.dtype == torch.float32
        pos = table[..., :3].numpy().reshape(-1, 3)
        i0 = table[..., 3].contiguous().view(torch.int32).numpy().reshape(-1)
        rays = zip(entry_uv.numpy().reshape(-1, 3), dir_step.numpy().reshape(-1, 3),
                   hit.numpy().reshape(-1))
        for k, (e, d, h) in enumerate(rays):
            want_pos, want_i0 = _replay(e, d, h, dims, box, max_samples)
            assert i0[k] == want_i0, (scene, box, k)
            assert np.array_equal(pos[k].view(np.int32), want_pos.view(np.int32)), (scene, box, k)
        assert (i0 != NO_ENTRY).sum() > 0


def _march_pair(vol_u8, rays, max_samples, shard, tf):
    """The walking plain march and the one from the table, on one shard."""
    z_lo, n_z, y_lo, n_y = shard
    Z, Y, X = vol_u8.shape
    dims, box = (X, Y, Z), (z_lo, z_lo + n_z, y_lo, y_lo + n_y)
    sample = shard_sampler(as_normalized_volume(_slab(vol_u8, z_lo, n_z, y_lo, n_y),
                                                device="cpu"), dims, z_lo, y_lo)
    entry_uv, dir_step, hit = rays
    table = seg_entry_table(entry_uv, dir_step, hit.bool(), dims, box, max_samples)
    if tf:
        t = torch.tensor(TF)
        return [seg_tf_march_steps(sample, entry_uv, dir_step, hit.bool(), t, dims, box,
                                   max_samples, s) for s in (None, table)]
    return [seg_march_steps(sample, entry_uv, dir_step, hit.bool(), dims, box, max_samples, s)
            for s in (None, table)]


@pytest.mark.parametrize("layout", ["zslab", "brick"])
@pytest.mark.parametrize("scene", ["front", "oblique", "grazing", "cut_at_max_samples"])
def test_march_from_table_equals_walking_march(scene, layout):
    vol, rays, max_samples = _scene(scene)
    owned = 0
    for shard in _shards(vol, layout):
        for tf in (False, True):
            walk, started = _march_pair(vol, rays, max_samples, shard, tf)
            for name, a, b in zip(NAMES, walk, started):
                assert torch.equal(a, b), (scene, layout, shard, tf, name)
            owned += int((walk[2] < BIG_T).sum())
    assert owned > 20


def test_rays_a_shard_never_owns_are_the_identity():
    """In a 2x2 brick layout most front rays stay in one y half: the two
    bricks of the other half own none of their steps, the table says so and
    the march from it writes the identity."""
    vol, rays, max_samples = _scene("front")
    entry_uv, dir_step, hit = rays
    dims = vol.shape[::-1]
    never = 0
    for shard in _shards(vol, "brick"):
        z_lo, n_z, y_lo, n_y = shard
        box = (z_lo, z_lo + n_z, y_lo, y_lo + n_y)
        table = seg_entry_table(entry_uv, dir_step, hit.bool(), dims, box, max_samples)
        none = (table[..., 3].contiguous().view(torch.int32) == NO_ENTRY) & hit.bool()
        assert not table[none][:, :3].any()
        walk, started = _march_pair(vol, rays, max_samples, shard, True)
        for a, b in zip(walk, started):
            assert torch.equal(a, b)
        C, A, t_first = started[:3]
        assert not C[none].any() and not A[none].any() and bool((t_first[none] == BIG_T).all())
        never += int(none.sum())
    assert 2 * never >= 3 * int(hit.sum())


def test_last_shard_halo_from_table():
    """The last z-slab without its halo plane: its taps clamp at the face,
    and the march from the table equals the walking one."""
    vol, (entry_uv, dir_step, hit), _ = _scene("oblique")
    Z, Y, X = vol.shape
    z_lo = Z // 2
    dims, box = (X, Y, Z), (z_lo, Z, 0, Y)
    kw = dict(dims=dims, z_lo=z_lo, n_z=Z - z_lo, y_lo=0, n_y=Y)
    starts = SK.seg_entry_table_cuda(entry_uv, dir_step, hit, **kw)
    slab = torch.from_numpy(np.ascontiguousarray(vol[z_lo:]))
    got = SK.seg_march_cuda(slab, entry_uv, dir_step, hit, **kw, starts=starts)
    want = SK.seg_march_cuda(slab, entry_uv, dir_step, hit, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int((got[2] < BIG_T).sum()) > 20 and starts.box == box


def _sharded_plan(vol):
    Z, Y, X = vol.shape
    rays = generate_rays(OBLIQUE, device="cpu")
    return plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z))


def test_cached_table_is_built_once_per_plan_and_box(monkeypatch):
    """Two renders of one plan build each shard's table once; the brick
    fit step reuses the brick renders' tables; a new plan builds anew."""
    builds = []
    build = KS.seg_entry_table_cuda

    def counted(*args, **kw):
        builds.append((kw["z_lo"], kw["y_lo"]))
        return build(*args, **kw)

    monkeypatch.setattr(KS, "seg_entry_table_cuda", counted)
    vol = as_normalized_volume(turbulence_volume((32, 24, 40), seed=2), device="cpu")
    plan = _sharded_plan(vol)
    zmesh = context.make_z_mesh(4, devices=CPU4)
    bmesh = bricks.make_brick_mesh((2, 2, 1), devices=CPU4)
    frames = [KS.render_zsharded_kernel(zmesh, plan, vol) for _ in range(2)]
    assert len(builds) == 4 and len(plan.seg_starts) == 4
    frames += [KS.render_bricksharded_kernel(bmesh, plan, vol) for _ in range(2)]
    assert len(builds) == 8 and len(plan.seg_starts) == 8
    from volumerenderer_tpu_torch import TFParams
    KS.tf_fit_step_bricksharded(bmesh, plan, TFParams.reference("cpu"), vol,
                                torch.full((*plan.shape, 3), 0.5))
    assert len(builds) == 8
    assert all(torch.equal(a, b) for a, b in zip(frames[0], frames[1]))
    KS.render_zsharded_kernel(zmesh, _sharded_plan(vol), vol)
    assert len(builds) == 12


def test_cached_tables_render_as_the_walking_marches():
    """A sharded frame from cached tables equals, bit for bit, the frame
    composed from the walking plain marches of each shard."""
    vol = as_normalized_volume(turbulence_volume((32, 24, 40), seed=2), device="cpu")
    plan = _sharded_plan(vol)
    mesh = bricks.make_brick_mesh((2, 2, 1), devices=CPU4)
    C, A, T = KS._seg_launches(mesh, plan, vol, None)
    for i, (slab, kw) in enumerate(KS.seg_shards(mesh, plan, vol)):
        walk = SK.seg_march_cuda(slab, plan.entry_uv, plan.dir_step, plan.hit, **kw)
        assert all(torch.equal(a, b[i]) for a, b in zip(walk, (C, A, T)))
    assert len(plan.seg_starts) == 4


def test_march_from_table_matches_jax_launch_seg():
    jax_planes, port = _jax_segment(False, "brick_10_of_22", starts=True)
    C, A, t_first = port
    assert (t_first < BIG_T).sum() > 100
    np.testing.assert_allclose(C, jax_planes[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(A, jax_planes[1], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t_first, jax_planes[2])


def _wrapper_case():
    vol, (entry_uv, dir_step, hit), _ = _scene("oblique")
    Z, Y, X = vol.shape
    kw = dict(dims=(X, Y, Z), z_lo=0, n_z=16, y_lo=0, n_y=Y)
    slab = torch.from_numpy(_slab(vol, 0, 16, 0, Y, hy=0))
    return slab, (entry_uv, dir_step, hit), kw


def test_wrapper_rejects_a_table_for_another_shard():
    slab, rays, kw = _wrapper_case()
    other = SK.seg_entry_table_cuda(*rays, **{**kw, "z_lo": 16})
    with pytest.raises(ValueError, match="built for"):
        SK.seg_march_cuda(slab, *rays, **kw, starts=other)
    cut = SK.seg_entry_table_cuda(*rays, **kw, max_samples=30)
    with pytest.raises(ValueError, match="built for"):
        SK.seg_tf_march_cuda(slab, *rays, torch.tensor(TF), **kw, starts=cut)
    with pytest.raises(TypeError, match="SegStarts"):
        SK.seg_march_cuda(slab, *rays, **kw, starts=other.entry)


def test_table_wrapper_checks_its_inputs():
    _, (entry_uv, dir_step, hit), kw = _wrapper_case()
    before = SK.seg_entry_table_cuda.launches
    with pytest.raises(ValueError, match="leaves the volume"):
        SK.seg_entry_table_cuda(entry_uv, dir_step, hit, **{**kw, "n_z": 40})
    with pytest.raises(ValueError, match="uint8"):
        SK.seg_entry_table_cuda(entry_uv, dir_step, hit.bool(), **kw)
    with pytest.raises(ValueError, match="float32"):
        SK.seg_entry_table_cuda(entry_uv.double(), dir_step, hit, **kw)
    starts = SK.seg_entry_table_cuda(entry_uv, dir_step, hit, **kw)
    assert SK.seg_entry_table_cuda.launches == before  # CPU tensors: the plain version
    want = seg_entry_table(entry_uv, dir_step, hit.bool(), kw["dims"], (0, 16, 0, 24))
    assert torch.equal(starts.entry.view(torch.int32), want.view(torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_shards(device):
    """Both layouts of a 64^2 x 96 turbulence at 96 x 64 rays, front and
    oblique, as (slab, rays, launch keywords)."""
    vol = turbulence_volume((64, 64, 96), seed=1)
    dims = (96, 64, 64)
    for camera in (Camera(width=96, height=64),
                   Camera(width=96, height=64, position=(0.3, 0.1, -0.7),
                          front=(-0.35, -0.1, 0.93))):
        rays = _camera_rays(dims, camera, device)
        for layout in ("zslab", "brick"):
            for z_lo, n_z, y_lo, n_y in _shards(vol, layout):
                slab = _slab(vol, z_lo, n_z, y_lo, n_y, hy=0 if n_y == 64 else 1)
                yield torch.from_numpy(slab).to(device), rays, dict(dims=dims, z_lo=z_lo,
                                                                     n_z=n_z, y_lo=y_lo, n_y=n_y)


@pytest.mark.cuda
def test_table_kernel_matches_plain_on_cuda(cuda_device):
    for _, rays, kw in _card_shards(cuda_device):
        before = SK.seg_entry_table_cuda.launches
        got = SK.seg_entry_table_cuda(*rays, **kw)
        torch.cuda.synchronize()
        assert SK.seg_entry_table_cuda.launches == before + 1
        box = (kw["z_lo"], kw["z_lo"] + kw["n_z"], kw["y_lo"], kw["y_lo"] + kw["n_y"])
        want = seg_entry_table(rays[0], rays[1], rays[2].bool(), kw["dims"], box)
        assert torch.equal(got.entry.view(torch.int32), want.view(torch.int32)), kw


@pytest.mark.cuda
def test_marches_from_table_match_plain_on_cuda(cuda_device):
    """B10 and B11 from a prebuilt table against the walking plain
    versions, every plane bit for bit; without a table the wrapper builds
    one first."""
    tf = torch.tensor(TF, device=cuda_device)
    for slab, rays, kw in _card_shards(cuda_device):
        starts = SK.seg_entry_table_cuda(*rays, **kw)
        box = (kw["z_lo"], kw["z_lo"] + kw["n_z"], kw["y_lo"], kw["y_lo"] + kw["n_y"])
        sample = shard_sampler(as_normalized_volume(slab), kw["dims"], kw["z_lo"], kw["y_lo"])
        entry_uv, dir_step, hit = rays
        want = seg_march_steps(sample, entry_uv, dir_step, hit.bool(), kw["dims"], box)
        want_tf = seg_tf_march_steps(sample, entry_uv, dir_step, hit.bool(), tf, kw["dims"], box)
        before = (SK.seg_entry_table_cuda.launches, SK.seg_march_cuda.launches)
        got = SK.seg_march_cuda(slab, *rays, **kw, starts=starts)
        got_built = SK.seg_march_cuda(slab, *rays, **kw)
        got_tf = SK.seg_tf_march_cuda(slab, *rays, tf, **kw, starts=starts)
        torch.cuda.synchronize()
        assert (SK.seg_entry_table_cuda.launches, SK.seg_march_cuda.launches) == (
            before[0] + 1, before[1] + 2)
        for name, g, b, w in zip(NAMES, got, got_built, want):
            assert torch.equal(g, w) and torch.equal(b, w), (kw, name)
        for name, g, w in zip(NAMES, got_tf, want_tf):
            assert torch.equal(g, w), (kw, name)
