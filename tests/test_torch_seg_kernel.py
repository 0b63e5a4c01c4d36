"""The segment marches on one volume shard (B10, B11), their wrappers, the
shard sampler and the composition of the shards' TF sums.

On CPU tensors the wrappers run the plain PyTorch versions; they are held
against the JAX package's ``launch_seg`` / ``launch_seg_tf`` run in interpret
mode with the word tables of ``build_word_table_seg``, as
tests/test_kernel_sharded.py runs them: C and alpha within 1e-6, ``t_first``
equal, the TF sums within 1e-6 relative.  The kernels run only where there is
a CUDA device: the ``cuda``-marked tests hold them against the plain versions
there, bit for bit (``--fmad=false``, the plain versions' order).

The machine with the card has no JAX, so this file imports JAX only inside
the tests that compare with it; there the card's tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_seg_kernel.py``.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
from volumerenderer_tpu_torch.diff.closed_form import seg_tf_march_steps
from volumerenderer_tpu_torch.interop import rays_from_numpy
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import seg_kernel as SK
from volumerenderer_tpu_torch.ops.raycast import BIG_T, seg_march_steps, shard_owned, step_sizes
from volumerenderer_tpu_torch.ops.sampling import sample_trilinear, shard_sampler

VOL_SHAPE = (32, 32, 128)  # (Z, Y, X), tests/test_kernel_sharded.py's segment volume
TF = (0.45, 0.9, 0.05)  # non-reference (K, G, B) of tests/test_pallas_interpret.py
NAMES = ("C", "alpha", "t_first", "R", "P", "QP", "SG", "SB")


def _volume_u8(shape=VOL_SHAPE, seed=11):
    rng = np.random.default_rng(seed)
    return np.round(rng.random(shape) * 255.0).astype(np.uint8)


def _jax_rays():
    import volumerenderer_tpu as J

    rays = J.generate_rays(J.Camera(width=64, height=32))
    return tuple(np.asarray(a) for a in (rays.entry_uv, rays.direction, rays.hit))


def _slab(vol_u8: np.ndarray, z_lo, n_z, y_lo, n_y, hz=1, hy=1):
    """The shard's rows and halo from the global volume, edge rows repeated
    past the volume's faces (what the halo exchange gives)."""
    Z, Y, _ = vol_u8.shape
    zi = np.clip(np.arange(z_lo, z_lo + n_z + hz), 0, Z - 1)
    yi = np.clip(np.arange(y_lo, y_lo + n_y + hy), 0, Y - 1)
    return np.ascontiguousarray(vol_u8[zi][:, yi])


# shard: (layout, z_lo, n_z, y_lo, n_y); n_y None = y unsharded
SHARDS = {"z_of_4": (8, 8, 0, None), "brick_10_of_22": (16, 16, 0, 16),
          "brick_01_of_22": (0, 16, 16, 16), "z_2_of_4": (16, 8, 0, None)}


def _jax_segment(tf: bool, shard: str, starts: bool = False):
    """One shard through the JAX kernel in interpret mode, and the port's
    wrapper on the same CPU inputs (from the shard's entry table where
    ``starts``).  Returns (jax planes, port planes)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    import volumerenderer_tpu as J
    from volumerenderer_tpu.ops.pallas import raycast_kernel as JK
    from volumerenderer_tpu.ops.pallas.seg_kernel import (Y_HALO, build_word_table_seg,
                                                          launch_seg, launch_seg_tf)
    from conftest import EAGER_INTERPRET

    z_lo, n_z, y_lo, n_y = SHARDS[shard]
    vol_u8 = _volume_u8()
    Z, Y, X = vol_u8.shape
    entry_uv, direction, hit = _jax_rays()
    H, W = hit.shape
    ext_j = _slab(vol_u8, z_lo, n_z, y_lo, Y if n_y is None else n_y,
                  hy=0 if n_y is None else Y_HALO)
    with pltpu.force_tpu_interpret_mode(EAGER_INTERPRET):
        plan = JK.CompositingPlan(entry_uv, direction, hit, (X, Y, Z), max_samples=24,
                                  win_z_cap=n_z)
        assert plan.use_kernel and plan.group > 1
        kw = dict(k=plan.group, win_y=plan.win_y, z_lo=z_lo, n_z=n_z, ext_z=n_z + 1)
        if n_y is not None:
            kw.update(y_lo=y_lo, n_y=n_y, ext_y=n_y + Y_HALO)
        words = build_word_table_seg(plan.mins, plan.maxs, plan.dims, plan.win_z,
                                     plan.max_samples, **kw)
        zr = jnp.asarray([[z_lo, z_lo + n_z, y_lo, y_lo + (Y if n_y is None else n_y),
                           0, 0, 0, 0]], jnp.int32)
        args = (plan.rays_packed, words, J.as_normalized_volume(ext_j), zr)
        launch = dict(dims=plan.dims, max_samples=24, win_z=plan.win_z, group=plan.group,
                      win_y=plan.win_y, lanes=plan.lanes)
        G = plan.lanes
        if tf:
            out = launch_seg_tf(*args, jnp.asarray([TF], jnp.float32), **launch)
            planes = [out[:, f * G:(f + 1) * G, :] for f in range(8)]
        else:
            planes = launch_seg(*args, **launch)
        jax_planes = [np.asarray(JK._untile(p, H, W, G)) for p in planes]
    rays = rays_from_numpy(entry_uv, direction, hit, device="cpu")
    dir_step = (rays.direction * step_sizes((X, Y, Z), "cpu")).contiguous()
    n_y = Y if n_y is None else n_y
    slab = torch.from_numpy(_slab(vol_u8, z_lo, n_z, y_lo, n_y, hy=0 if n_y == Y else 1))
    call = dict(dims=(X, Y, Z), z_lo=z_lo, n_z=n_z, y_lo=y_lo, n_y=n_y, max_samples=24)
    hit_u8 = rays.hit.to(torch.uint8)
    if starts:
        call["starts"] = SK.seg_entry_table_cuda(rays.entry_uv, dir_step, hit_u8, **call)
    if tf:
        port = SK.seg_tf_march_cuda(slab, rays.entry_uv, dir_step, hit_u8, torch.tensor(TF),
                                    **call)
    else:
        port = SK.seg_march_cuda(slab, rays.entry_uv, dir_step, hit_u8, **call)
    return jax_planes, [p.numpy() for p in port]


@pytest.mark.parametrize("shard", ["z_of_4", "brick_10_of_22"])
def test_seg_march_matches_jax_launch_seg(shard):
    jax_planes, port = _jax_segment(False, shard)
    C, A, t_first = port
    assert (t_first < BIG_T).sum() > 100
    assert float(A.max()) > 0.3
    np.testing.assert_allclose(C, jax_planes[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(A, jax_planes[1], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t_first, jax_planes[2])


@pytest.mark.parametrize("shard", ["brick_01_of_22", "z_2_of_4"])
def test_seg_tf_march_matches_jax_launch_seg_tf(shard):
    jax_planes, port = _jax_segment(True, shard)
    assert (port[2] < BIG_T).sum() > 100
    np.testing.assert_array_equal(port[2], jax_planes[2])
    for name, p, j in zip(NAMES, port, jax_planes):
        if name != "t_first":
            np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6, err_msg=name)


def test_compose_tf_segments_matches_jax():
    import jax.numpy as jnp

    from volumerenderer_tpu.ops.pallas.seg_kernel import compose_tf_segments as jax_compose

    rng = np.random.default_rng(5)
    N, H, W = 4, 6, 10
    planes = [rng.random((N, H, W)).astype(np.float32) for _ in range(8)]
    planes[1] *= 0.8  # alpha_seg < 1
    t_first = rng.permuted(np.tile(np.arange(N, dtype=np.float32)[:, None, None] * 7.0,
                                   (1, H, W)), axis=0)
    t_first[0, :2] = BIG_T  # shards that own no sample of these rays
    planes[2] = t_first
    for i in (0, 1, 3, 4, 5, 6, 7):
        planes[i][0, :2] = 0.0  # ... are identity maps
    got = SK.compose_tf_segments(*(torch.from_numpy(p) for p in planes))
    want = jax_compose(*(jnp.asarray(p) for p in planes))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_shard_sampler_equals_dense_sampler_on_owned_anchors():
    vol_u8 = _volume_u8((16, 12, 20), seed=3)
    Z, Y, X = vol_u8.shape
    dense = as_normalized_volume(vol_u8, device="cpu")
    rng = np.random.default_rng(4)
    uvw = torch.from_numpy(rng.random((4000, 3)).astype(np.float32))
    for z_lo, n_z, y_lo, n_y in [(0, 8, 0, 6), (8, 8, 6, 6), (4, 4, 0, 12)]:
        slab = as_normalized_volume(_slab(vol_u8, z_lo, n_z, y_lo, n_y), device="cpu")
        box = (z_lo, z_lo + n_z, y_lo, y_lo + n_y)
        owned = shard_owned(uvw, (X, Y, Z), box)
        got = shard_sampler(slab, (X, Y, Z), z_lo, y_lo)(uvw)
        want = sample_trilinear(dense, uvw)
        assert int(owned.sum()) > 100
        assert torch.equal(got[owned], want[owned])


def _grazing_rays(dims, n=64):
    """Rays that pass the corner (z, y) = (0.5, 0.5) of the cube's shards,
    each a hair's breadth off it, along (0, 1, 1) and nearby."""
    rng = np.random.default_rng(8)
    off = rng.uniform(-2e-3, 2e-3, (n, 3)).astype(np.float32)
    entry = np.array([0.37, 1e-3, 1e-3], np.float32) + off * np.array([50, 1, 1], np.float32)
    direction = np.array([0.0, 1.0, 1.0], np.float32) + off * 10.0
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    entry_uv = torch.from_numpy(entry).reshape(8, n // 8, 3).contiguous()
    d = torch.from_numpy(direction).reshape(8, n // 8, 3)
    dir_step = (d * step_sizes(dims, "cpu")).contiguous()
    return entry_uv, dir_step, torch.ones((8, n // 8), dtype=torch.uint8)


def test_owned_steps_of_a_ray_form_one_interval():
    """What lets the kernel leave a ray's loop after its owned interval: on
    rays grazing a brick corner, the owned steps of each ray are contiguous,
    and the plain march's output equals its output cut at the interval's
    end."""
    dims = (16, 16, 16)
    entry_uv, dir_step, hit = _grazing_rays(dims)
    boxes = [(8, 16, 8, 16), (0, 8, 8, 16), (8, 16, 0, 8), (0, 8, 0, 8)]
    vol = as_normalized_volume(_volume_u8((16, 16, 16), seed=9), device="cpu")
    for box in boxes:
        pos, alive = entry_uv, hit.bool()
        owned_steps = []
        for _ in range(40):
            pos = pos + dir_step
            alive = alive & ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
            owned_steps.append(alive & shard_owned(pos, dims, box))
        owned = torch.stack(owned_steps).reshape(40, -1).T.numpy()
        for row in owned:
            idx = np.nonzero(row)[0]
            assert idx.size == 0 or idx[-1] - idx[0] + 1 == idx.size, (box, idx)
        assert owned.any(axis=1).sum() > 10
        full = seg_march_steps(vol, entry_uv, dir_step, hit.bool(), dims, box, 40)
        last = max(int(np.nonzero(r)[0][-1]) + 1 for r in owned if r.any())
        cut = seg_march_steps(vol, entry_uv, dir_step, hit.bool(), dims, box, last)
        assert all(torch.equal(a, b) for a, b in zip(full, cut))


def _face_scene():
    """A (16, 16, 16) volume in two z-shards, and rays entering at the
    z = Z face, looking down -z."""
    vol_u8 = _volume_u8((16, 16, 16), seed=12)
    rays = generate_rays(Camera(position=(0.05, -0.1, 0.75), front=(0.0, 0.0, -1.0),
                                width=16, height=16), device="cpu")
    dir_step = (rays.direction * step_sizes((16, 16, 16), "cpu")).contiguous()
    return vol_u8, rays.entry_uv, dir_step, rays.hit.to(torch.uint8)


def test_last_shard_halo_is_never_read():
    """The last shard's taps clamp at the volume's face, so what its halo
    plane holds, or whether it has one, changes nothing."""
    vol_u8, entry_uv, dir_step, hit = _face_scene()
    owned = torch.from_numpy(vol_u8[8:16].copy())
    outs = []
    for halo in (None, vol_u8[15:16], np.full((1, 16, 16), 255, np.uint8)):
        slab = owned if halo is None else torch.from_numpy(np.concatenate([vol_u8[8:16], halo]))
        outs.append(SK.seg_march_cuda(slab, entry_uv, dir_step, hit, (16, 16, 16), 8, 8, 0, 16,
                                      max_samples=40))
    assert float(outs[0][1].max()) > 0.3 and float(outs[0][2].min()) == 0.0
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


def test_shard_without_samples_is_the_identity():
    vol_u8, entry_uv, dir_step, hit = _face_scene()
    hit = torch.zeros_like(hit)
    C, A, t_first = SK.seg_march_cuda(torch.from_numpy(vol_u8[0:9].copy()), entry_uv, dir_step,
                                      hit, (16, 16, 16), 0, 8, 0, 16, max_samples=40)
    assert not C.any() and not A.any() and bool((t_first == BIG_T).all())


def _wrapper_inputs():
    vol_u8, entry_uv, dir_step, hit = _face_scene()
    return dict(slab_u8=torch.from_numpy(vol_u8[4:13].copy()), entry_uv=entry_uv,
                dir_step=dir_step, hit=hit, dims=(16, 16, 16), z_lo=4, n_z=8, y_lo=0, n_y=16)


def test_wrappers_cpu_run_plain_versions():
    before = (SK.seg_march_cuda.launches, SK.seg_tf_march_cuda.launches)
    kw = _wrapper_inputs()
    tf = torch.tensor(TF)
    got = SK.seg_march_cuda(**kw, max_samples=30)
    got_tf = SK.seg_tf_march_cuda(**kw, tf_scalars=tf, max_samples=30)
    sample = shard_sampler(as_normalized_volume(kw["slab_u8"]), kw["dims"], 4, 0)
    box = (4, 12, 0, 16)
    want = seg_march_steps(sample, kw["entry_uv"], kw["dir_step"], kw["hit"].bool(),
                           kw["dims"], box, 30)
    want_tf = seg_tf_march_steps(sample, kw["entry_uv"], kw["dir_step"], kw["hit"].bool(), tf,
                                 kw["dims"], box, 30)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got_tf, want_tf))
    assert float(got[1].max()) > 0.1
    assert (SK.seg_march_cuda.launches, SK.seg_tf_march_cuda.launches) == before


@pytest.mark.parametrize("field,value,match", [
    ("slab_u8", lambda kw: kw["slab_u8"].float(), "uint8"),
    ("slab_u8", lambda kw: kw["slab_u8"][:8].contiguous(), "halo"),
    ("slab_u8", lambda kw: kw["slab_u8"][:, :, :8].contiguous(), "halo"),
    ("y_lo", lambda kw: 2, "leaves the volume"),
    ("n_z", lambda kw: 13, "leaves the volume"),
    ("z_lo", lambda kw: -1, "non-negative"),
    ("hit", lambda kw: kw["hit"].bool(), "uint8"),
    ("dir_step", lambda kw: kw["dir_step"].double(), "float32"),
])
def test_wrapper_rejects_bad_inputs(field, value, match):
    kw = _wrapper_inputs()
    kw[field] = value(kw)
    with pytest.raises((ValueError, TypeError), match=match):
        SK.seg_march_cuda(**kw)


def test_tf_wrapper_rejects_bad_tf_scalars():
    with pytest.raises(ValueError, match="tf_scalars"):
        SK.seg_tf_march_cuda(**_wrapper_inputs(), tf_scalars=torch.zeros(4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_cases(device):
    vol_u8 = turbulence_volume((64, 64, 96), seed=1)
    rays = generate_rays(Camera(width=96, height=64, position=(0.3, 0.1, -0.7),
                                front=(-0.35, -0.1, 0.93)), device=device)
    dims = (96, 64, 64)
    dir_step = (rays.direction * step_sizes(dims, device)).contiguous()
    for z_lo, n_z, y_lo, n_y in [(16, 16, 0, 64), (48, 16, 0, 64), (32, 32, 32, 32),
                                 (0, 32, 0, 32)]:
        slab = torch.from_numpy(_slab(vol_u8, z_lo, n_z, y_lo, n_y,
                                      hy=0 if n_y == 64 else 1)).to(device)
        yield slab, (rays.entry_uv, dir_step, rays.hit.to(torch.uint8)), dict(
            dims=dims, z_lo=z_lo, n_z=n_z, y_lo=y_lo, n_y=n_y)


def _plain(slab, rays, kw, tf=None):
    box = (kw["z_lo"], kw["z_lo"] + kw["n_z"], kw["y_lo"], kw["y_lo"] + kw["n_y"])
    sample = shard_sampler(as_normalized_volume(slab), kw["dims"], kw["z_lo"], kw["y_lo"])
    entry_uv, dir_step, hit = rays
    if tf is None:
        return seg_march_steps(sample, entry_uv, dir_step, hit.bool(), kw["dims"], box)
    return seg_tf_march_steps(sample, entry_uv, dir_step, hit.bool(), tf, kw["dims"], box)


@pytest.mark.cuda
def test_seg_march_kernel_matches_plain_on_cuda(cuda_device):
    """B10 against its plain version on the same card and inputs, every
    plane bit for bit (the B1 bar is 1e-5)."""
    for slab, rays, kw in _card_cases(cuda_device):
        before = SK.seg_march_cuda.launches
        got = SK.seg_march_cuda(slab, *rays, **kw)
        torch.cuda.synchronize()
        assert SK.seg_march_cuda.launches == before + 1
        want = _plain(slab, rays, kw)
        assert int((got[2] < BIG_T).sum()) > 100
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), (kw, name, float((g - w).abs().max()))


@pytest.mark.cuda
def test_seg_tf_march_kernel_matches_plain_on_cuda(cuda_device):
    """B11 against its plain version, all eight planes bit for bit (the B4
    bar is 1e-6 relative)."""
    tf = torch.tensor(TF, device=cuda_device)
    for slab, rays, kw in _card_cases(cuda_device):
        before = SK.seg_tf_march_cuda.launches
        got = SK.seg_tf_march_cuda(slab, *rays, tf, **kw)
        torch.cuda.synchronize()
        assert SK.seg_tf_march_cuda.launches == before + 1
        for name, g, w in zip(NAMES, got, _plain(slab, rays, kw, tf)):
            assert torch.equal(g, w), (kw, name, float((g - w).abs().max()))


@pytest.mark.cuda
def test_kernel_leaves_after_the_owned_interval_on_cuda(cuda_device):
    """Rays grazing a brick corner: the kernel, which leaves each ray's loop
    after its owned interval, equals the plain march, which walks on."""
    dims = (16, 16, 16)
    vol_u8 = _volume_u8((16, 16, 16), seed=9)
    entry_uv, dir_step, hit = (t.to(cuda_device) for t in _grazing_rays(dims))
    for z_lo, y_lo in [(8, 8), (0, 8), (8, 0), (0, 0)]:
        slab = torch.from_numpy(_slab(vol_u8, z_lo, 8, y_lo, 8)).to(cuda_device)
        kw = dict(dims=dims, z_lo=z_lo, n_z=8, y_lo=y_lo, n_y=8, max_samples=40)
        got = SK.seg_march_cuda(slab, entry_uv, dir_step, hit, **kw)
        want = seg_march_steps(shard_sampler(as_normalized_volume(slab), dims, z_lo, y_lo),
                               entry_uv, dir_step, hit.bool(), dims,
                               (z_lo, z_lo + 8, y_lo, y_lo + 8), 40)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_last_shard_halo_is_never_read_on_cuda(cuda_device):
    vol_u8, entry_uv, dir_step, hit = (t.to(cuda_device) if isinstance(t, torch.Tensor) else t
                                       for t in _face_scene())
    outs = []
    for halo in (None, vol_u8[15:16], np.full((1, 16, 16), 255, np.uint8)):
        slab = vol_u8[8:16] if halo is None else np.concatenate([vol_u8[8:16], halo])
        outs.append(SK.seg_march_cuda(torch.from_numpy(np.ascontiguousarray(slab)).to(cuda_device),
                                      entry_uv, dir_step, hit, (16, 16, 16), 8, 8, 0, 16,
                                      max_samples=40))
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))
