"""The port's slab pools and pool sampler against the JAX package.

``build_slab_pool`` must give exactly JAX's pool and slab map (with and
without a ``mip8``, on a sparse volume where dedup fires and on a dense
random one); the narrow pool must equal JAX's first X/128 chunks re-laid out;
and ``sample_trilinear_slab_pool`` must be bit-equal to ``sample_trilinear``
of the volume the pool was built from, x and z faces included (cf.
tests/test_pallas_interpret.py:152-197)."""
import numpy as np
import pytest
import torch

from volumerenderer_tpu.ops.pallas import raycast_kernel as JR
from volumerenderer_tpu.ops.sampling import as_normalized_volume as jax_normalized
from volumerenderer_tpu_torch import as_normalized_volume
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.sampling import (as_sampler, sample_trilinear,
                                                   sample_trilinear_slab_pool)


def _sparse_u8():
    """tests/test_pallas_interpret.py's sparse pooled scene, with a copy of
    its occupied slabs further down so dedup fires."""
    Z, Y, X = 48, 16, 256
    v = np.zeros((Z, Y, X), np.float32)
    v[9:14, 4:12, 30:200] = np.linspace(0.2, 1.0, 170, dtype=np.float32)
    u8 = np.round(v * 255.0).astype(np.uint8)
    u8[32:48] = u8[0:16]
    return u8


def _dense_u8():
    return np.round(np.random.default_rng(5).random((16, 16, 256)) * 255.0).astype(np.uint8)


SCENES = {"sparse_dedup": _sparse_u8, "dense_random": _dense_u8}


def _mip8(u8):
    return RK.block_max8(torch.from_numpy(u8))


@pytest.mark.parametrize("with_mip8", [False, True])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_build_slab_pool_matches_jax(scene, with_mip8):
    u8 = SCENES[scene]()
    mip8 = _mip8(u8) if with_mip8 else None
    pool_j, map_j = JR.build_slab_pool(jax_normalized(u8),
                                       mip8=None if mip8 is None else mip8.numpy())
    pool_t, map_t = RK.build_slab_pool(as_normalized_volume(u8, device="cpu"), mip8=mip8)
    assert pool_t.dtype == torch.int32 and map_t.dtype == torch.int32
    np.testing.assert_array_equal(pool_t.numpy(), np.asarray(pool_j))
    np.testing.assert_array_equal(map_t.numpy(), np.asarray(map_j))
    assert not pool_t[0].any()
    if scene == "sparse_dedup":
        # six slabs: z-blocks 0, 1 and 4, 5 occupied (via overlap), 2 and 3
        # deduped onto 0 and 1's slots
        assert map_t.tolist() == [[1, 2, 0, 0, 1, 2]] and pool_t.shape[0] == 3
    else:
        assert pool_t.shape[0] == 1 + 2


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_narrow_pool_is_jax_first_chunks_relaid(scene):
    u8 = SCENES[scene]()
    Z, Y, X = u8.shape
    pool_j, map_j = JR.build_slab_pool_narrow(jax_normalized(u8))
    pool_t, map_t = RK.build_slab_pool_narrow(as_normalized_volume(u8, device="cpu"))
    C = X // 128
    relaid = np.asarray(pool_j)[:C].reshape(C, -1, RK.SLAB_H, Y, 128) \
        .transpose(1, 2, 3, 0, 4).reshape(-1, RK.SLAB_H, Y, X)
    assert pool_t.dtype == torch.float32 and tuple(pool_t.shape) == relaid.shape
    np.testing.assert_array_equal(pool_t.numpy(), relaid)
    np.testing.assert_array_equal(map_t.numpy(), np.asarray(map_j))
    # same slots as the pair16 pool; uint8 input gives the same pools
    pool16, map16 = RK.build_slab_pool(torch.from_numpy(u8))
    assert torch.equal(map16, map_t) and pool16.shape[0] == pool_t.shape[0]
    assert torch.equal(RK.build_slab_pool_narrow(torch.from_numpy(u8))[0], pool_t)


def test_packing_matches_jax():
    u8 = _dense_u8()[:, :, :20]
    vj, vt = jax_normalized(u8), as_normalized_volume(u8, device="cpu")
    np.testing.assert_array_equal(RK.pack_pairs(vt).numpy(), np.asarray(JR.pack_pairs(vj)))
    np.testing.assert_array_equal(RK.pack_pairs16(vt).numpy(), np.asarray(JR.pack_pairs16(vj)))
    odd = as_normalized_volume(_dense_u8()[:, :11, :13], device="cpu")  # ragged blocks
    np.testing.assert_array_equal(RK.block_max8(odd).numpy(),
                                  np.asarray(JR.block_max8(jax_normalized(odd.numpy()))))


@pytest.mark.parametrize("build", ["pair16", "narrow"])
@pytest.mark.parametrize("shape", [(16, 8, 32), (24, 5, 6)])
def test_pool_sampler_bit_equal_to_dense(build, shape):
    rng = np.random.default_rng(sum(shape))
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    u8[8:16] = 0  # an empty z-block between occupied ones
    Z, Y, X = shape
    vol = as_normalized_volume(u8, device="cpu")
    pool, smap = (RK.build_slab_pool if build == "pair16" else RK.build_slab_pool_narrow)(vol)
    n = 6000
    uvw = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    # both x faces and both z faces, inside and just outside the cube
    face = rng.uniform(0.0, 1.0, (8, 400, 3)).astype(np.float32)
    for k, (axis, value) in enumerate([(0, 0.0), (0, 1.0), (2, 0.0), (2, 1.0),
                                       (0, 0.5 / X), (0, 1 - 0.5 / X), (2, 0.5 / Z),
                                       (2, 1 - 0.5 / Z)]):
        face[k, :, axis] = value + rng.uniform(-0.6, 0.6, 400).astype(np.float32) / [X, Y, Z][axis]
    uvw = torch.from_numpy(np.concatenate([uvw, face.reshape(-1, 3)]))
    want = sample_trilinear(vol, uvw, "clamp")
    got = sample_trilinear_slab_pool(pool, smap, (X, Y, Z), uvw)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_build_slab_pool_rejects_bad_shapes():
    with pytest.raises(ValueError, match="Z % 8"):
        RK.build_slab_pool(torch.zeros(12, 4, 4))
    with pytest.raises(ValueError, match="even"):
        RK.build_slab_pool(torch.zeros(8, 4, 5))
    with pytest.raises(ValueError, match="Z % 8"):
        RK.build_slab_pool_narrow(torch.zeros(12, 4, 5))
    # the narrow pool takes any X
    pool, smap = RK.build_slab_pool_narrow(torch.ones(8, 4, 5))
    assert tuple(pool.shape) == (2, RK.SLAB_H, 4, 5) and smap.tolist() == [[1]]


@pytest.mark.parametrize("pool,smap,match", [
    (torch.zeros(2, 16, 4, 4, dtype=torch.int64), torch.zeros(1, 1, dtype=torch.int32), "pool"),
    (torch.zeros(2, 8, 4, 4, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int32), "pool"),
    (torch.zeros(0, 16, 4, 4, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int32), "pool"),
    (torch.zeros(2, 16, 4, 4, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int64),
     "slab_map"),
    (torch.zeros(2, 16, 4, 4, dtype=torch.int32), torch.zeros(2, 1, dtype=torch.int32),
     "slab_map"),
])
def test_pool_dims_rejects_bad_pools(pool, smap, match):
    with pytest.raises(ValueError, match=match):
        RK.pool_dims(pool, smap)


def test_pool_dims():
    smap = torch.zeros(1, 3, dtype=torch.int32)
    assert RK.pool_dims(torch.zeros(2, 16, 5, 4, dtype=torch.int32), smap) == (8, 5, 24)
    assert RK.pool_dims(torch.zeros(2, 16, 5, 4), smap, "narrow") == (4, 5, 24)
    with pytest.raises(ValueError, match="pair16"):
        RK.pool_dims(torch.zeros(2, 16, 5, 4), smap, "pair16")


def test_as_sampler():
    vol = torch.rand(4, 4, 4)
    uvw = torch.rand(10, 3)
    assert torch.equal(as_sampler(vol, "repeat")(uvw), sample_trilinear(vol, uvw, "repeat"))
    f = lambda p: p[..., 0]  # noqa: E731
    assert as_sampler(f) is f
    with pytest.raises(ValueError, match="wrap"):
        as_sampler(vol, "mirror")
    with pytest.raises(TypeError, match="sampler"):
        as_sampler(3)
