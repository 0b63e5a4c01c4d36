"""The port's Morton-hashed kd-tree codec (``codecs/hashed.py``) against the
JAX package's (``volumerenderer_tpu/codecs/hashed.py``).

At tests/test_codec_hashed.py's sizes (16^3 and 16x32x16, tolerance 4), all
exact: the Python builders array for array, the host level cut at every
depth, the file bytes, the device decode on CPU tensors (flat and with its
chunking forced) against JAX's device decode and the host cut, int64 Morton
codes past 2^31 and 2^32, a JAX tree carried across, and BASELINE config 4
at CI size (8 bricks -> hashed build -> device decode -> TF step) with its
losses within rtol 2e-3 of JAX's.  The native builder is held against the
Python one on the card (tests/test_torch_codecs_cuda.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from volumerenderer_tpu.codecs import hashed as JH
from volumerenderer_tpu_torch.codecs import hashed as TH
from volumerenderer_tpu_torch.interop import hashed_from_numpy
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume

VOLUMES = {
    "uniform_16": lambda: np.full((16, 16, 16), 77, dtype=np.uint8),
    "turbulence_16": lambda: turbulence_volume((16, 16, 16), seed=13),
    "sphere_16": lambda: sphere_volume((16, 16, 16)),
    "turbulence_16x32x16": lambda: turbulence_volume((16, 32, 16), seed=5),
}
FIELDS = ("distance_map", "tree_data", "tree_structure", "coll_keys", "coll_vals", "coll_data",
          "coll_structure")


@pytest.fixture(scope="module")
def trees():
    """(volume, JAX tree, port tree) per volume, both Python builders."""
    out = {}
    for name, make in VOLUMES.items():
        vol = make()
        out[name] = (vol, JH.build(vol, tolerance=4, use_native=False),
                     TH.build(vol, tolerance=4, use_native=False))
    return out


def _assert_same_tree(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("dims", "orig_depth", "tree_depth", "hash_mask", "tolerance"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("name", list(VOLUMES))
def test_python_builder_equals_jax_array_for_array(trees, name):
    vol, j, t = trees[name]
    _assert_same_tree(t, j)
    assert t.num_collisions == j.num_collisions > 0
    assert t.tree_depth >= t.orig_depth


@pytest.mark.parametrize("name", list(VOLUMES))
def test_level_cut_every_depth_equals_jax(trees, name):
    vol, j, t = trees[name]
    for cut in range(t.tree_depth + 1):
        got = TH.level_cut(t, cut)
        assert got.shape == vol.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, JH.level_cut(j, cut))
    err = np.abs(TH.level_cut(t).astype(int) - vol.astype(int))
    assert err.mean() < 8.0


def test_save_open_roundtrip_and_file_bytes_equal_jax(trees, tmp_path):
    _, j, t = trees["turbulence_16"]
    tp, jp = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    TH.save(t, tp)
    JH.save(j, jp)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    for back in (TH.open_tree(tp), TH.open_tree(jp)):
        _assert_same_tree(dataclasses.replace(back, tolerance=t.tolerance), j)
        np.testing.assert_array_equal(TH.level_cut(back), TH.level_cut(t))
    np.testing.assert_array_equal(JH.level_cut(JH.open_tree(tp)), TH.level_cut(t))


@pytest.mark.parametrize("name", ["turbulence_16", "sphere_16"])
def test_device_decode_on_cpu_equals_jax_and_host(trees, name):
    _, j, t = trees[name]
    dev = TH.to_device_hashed(t, device="cpu")
    assert dev.node_bits.device.type == "cpu"
    jdev = JH.to_device_hashed(j)
    for cut in (4, t.orig_depth, t.tree_depth):
        host = TH.level_cut(t, cut)
        np.testing.assert_array_equal(np.asarray(JH.level_cut_device_hashed(j, jdev, cut)), host)
        for bits in (None, 4, 8):
            got = TH.level_cut_device_hashed(t, dev, cut, chunk_bits=bits)
            assert got.dtype == torch.uint8 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), host, err_msg=f"cut {cut} bits {bits}")


@pytest.mark.parametrize("group_bits", [TH.GROUP_LEAF_BITS, 6])
def test_device_decode_every_cut_and_chunking(trees, monkeypatch, group_bits):
    """Every cut, flat and in chunks; at 6 group bits the chunks go in
    several groups (a group of 2^6 leaves, up to 16 chunks)."""
    monkeypatch.setattr(TH, "GROUP_LEAF_BITS", group_bits)
    _, _, t = trees["turbulence_16x32x16"]
    dev = TH.to_device_hashed(t, device="cpu")
    for cut in range(t.tree_depth + 1):
        host = TH.level_cut(t, cut)
        for bits in (None, 2, 5, t.orig_depth - 2):
            np.testing.assert_array_equal(
                TH.level_cut_device_hashed(t, dev, cut, chunk_bits=bits).numpy(), host)


def test_int64_morton_codes_past_2_31_and_2_32():
    """Masks and sorted search on int64 codes at depths 31-33 equal numpy's
    (the counterpart of tests/test_codec_hashed.py's uint32 check), and the
    decode's lookup equals the host ``HashedKdTree.lookup``."""
    D = 18
    mask = (1 << D) - 1
    m64 = np.concatenate([(np.int64(1) << 31) + np.arange(64, dtype=np.int64) * 101,
                          (np.int64(1) << 32) + 7 + np.arange(64, dtype=np.int64) * 103,
                          (np.int64(1) << 33) + 13 + np.arange(64, dtype=np.int64) * 107])
    keys = np.sort(m64[::3])
    m = torch.from_numpy(m64)
    np.testing.assert_array_equal((m & mask).numpy(), m64 & mask)
    np.testing.assert_array_equal(torch.searchsorted(torch.from_numpy(keys), m).numpy(),
                                  np.searchsorted(keys, m64))

    rng = np.random.default_rng(0)
    n = 1 << D
    tree_data = rng.integers(0, 3, n).astype(np.uint8)
    tree_data[keys & mask] = 3
    coll_vals = rng.permutation(len(keys)).astype(np.int32)
    tree = TH.HashedKdTree(
        dims=(64, 64, 64), orig_depth=D, tree_depth=34, hash_mask=mask,
        distance_map=np.zeros(35, np.uint8), tree_data=tree_data,
        tree_structure=rng.integers(0, 4, n).astype(np.uint8), coll_keys=keys,
        coll_vals=coll_vals, coll_data=rng.integers(0, 3, len(keys)).astype(np.uint8),
        coll_structure=rng.integers(0, 4, len(keys)).astype(np.uint8))
    p = TH._Decode(TH.to_device_hashed(tree, device="cpu"), (0,) * 35, mask, 34, D, 34)
    key_set = set(keys.tolist())
    for depth in (31, 32, 33):
        q = m64[(m64 >> depth) == 1]
        q = q[[int(x) in key_set or tree_data[int(x) & mask] != 3 for x in q]]
        code, children = TH._lookup(p, torch.from_numpy(q), depth)
        want = np.array([tree.lookup(int(x)) for x in q])
        np.testing.assert_array_equal(code.numpy(), want[:, 0])
        np.testing.assert_array_equal(children.numpy(), want[:, 1])


def test_hashed_from_numpy_decodes_as_the_port_tree(trees):
    _, j, t = trees["sphere_16"]
    carried = hashed_from_numpy(**dataclasses.asdict(j))
    _assert_same_tree(carried, j)
    np.testing.assert_array_equal(TH.level_cut(carried), TH.level_cut(t))
    dev = TH.to_device_hashed(carried, device="cpu")
    np.testing.assert_array_equal(TH.level_cut_device_hashed(carried, dev).numpy(),
                                  TH.level_cut(t))
    with pytest.raises(TypeError, match="expected the fields"):
        hashed_from_numpy(dims=(16, 16, 16))


def test_builder_is_chosen_by_the_machine(monkeypatch):
    """With a CUDA device the native builder builds and a failed build
    raises; without one the Python builder builds; ``use_native`` forces
    either."""
    vol = turbulence_volume((8, 8, 8), seed=2)
    want = TH.build(vol, use_native=False)

    def broken(*_):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(TH, "_build_native", broken)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _assert_same_tree(TH.build(vol), want)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        TH.build(vol, use_native=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        TH.build(vol)
    _assert_same_tree(TH.build(vol, use_native=False), want)


def test_config4_pipeline_at_ci_size():
    """BASELINE config 4 (tests/test_codec_hashed.py:76): 8 bricks of 8^3 ->
    hashed build -> device decode -> TF loss and one SGD step at 32x16,
    each loss within rtol 2e-3 of JAX's, the loss falling."""
    import jax
    import jax.numpy as jnp
    from volumerenderer_tpu import Camera as JCamera, as_normalized_volume as j_norm
    from volumerenderer_tpu import generate_rays as j_rays
    from volumerenderer_tpu.diff.transfer import TFParams as JTFParams, tf_loss as j_tf_loss
    from volumerenderer_tpu.io import bricks as JB
    from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays
    from volumerenderer_tpu_torch.diff.transfer import TFParams, tf_loss
    from volumerenderer_tpu_torch.io import bricks as TB

    grid = TB.BrickGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))
    multi = TB.load_bricks(TB.synthetic_brick_source(grid), grid, 8, 2, 2, 2, 273)
    jgrid = JB.BrickGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))
    jmulti = JB.load_bricks(JB.synthetic_brick_source(jgrid), jgrid, 8, 2, 2, 2, 273)
    np.testing.assert_array_equal(multi, jmulti)
    tree = TH.build(multi, tolerance=4)
    jtree = JH.build(jmulti, tolerance=4)
    _assert_same_tree(tree, jtree)
    dec = TH.level_cut_device_hashed(tree, TH.to_device_hashed(tree, device="cpu"))
    np.testing.assert_array_equal(dec.numpy(), TH.level_cut(tree))
    jdec = JH.level_cut_device_hashed(jtree, JH.to_device_hashed(jtree))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))

    vol = as_normalized_volume(dec)
    rays = generate_rays(Camera(width=32, height=16), device="cpu")
    target = torch.full(rays.entry_uv.shape[:-1] + (3,), 0.5)
    params = TFParams.reference("cpu")
    jvol = j_norm(jdec)
    jr = j_rays(JCamera(width=32, height=16))
    jtarget = jnp.full(jr.entry_uv.shape[:-1] + (3,), 0.5, jnp.float32)
    jparams = JTFParams.reference()

    def loss_t(p):
        return tf_loss(p, vol, rays.entry_uv, rays.direction, rays.hit, target, max_samples=24)

    def loss_j(p):
        return j_tf_loss(p, jvol, jr.entry_uv, jr.direction, jr.hit, jtarget, max_samples=24)

    losses = []
    for _ in range(2):
        leaves = TFParams(*(x.clone().requires_grad_(True) for x in params))
        loss = loss_t(leaves)
        grads = torch.autograd.grad(loss, leaves)
        tl, jl = float(loss.detach()), float(loss_j(jparams))
        assert np.isfinite(tl) and abs(tl - jl) <= 2e-3 * abs(jl), (tl, jl)
        losses.append(tl)
        params = TFParams(*(x - 0.05 * g for x, g in zip(params, grads)))
        jg = jax.grad(loss_j)(jparams)
        jparams = jax.tree.map(lambda p, g: p - 0.05 * g, jparams, jg)
    assert losses[1] < losses[0]
