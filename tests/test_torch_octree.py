"""The port's octree codec (``codecs/octree.py``) against the JAX package's
(``volumerenderer_tpu/codecs/octree.py``) and against a recursive
transliteration of the reference's box-average build (``Octree.cpp:73-112``,
as tests/test_codec_octree.py writes it): every level's averages and the
level cut at every depth, on an (8, 4, 4) random volume, a 16^3 sphere and a
non-cubic (16, 8, 32) turbulence.  ``interop.octree_from_numpy`` carries a
JAX tree across."""
import dataclasses

import numpy as np
import pytest

from volumerenderer_tpu.codecs import octree as JO
from volumerenderer_tpu_torch.codecs import octree as TO
from volumerenderer_tpu_torch.interop import octree_from_numpy
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume

VOLUMES = {
    "random_8x4x4": lambda: np.random.default_rng(4).integers(0, 256, (8, 4, 4)).astype(np.uint8),
    "sphere_16": lambda: sphere_volume((16, 16, 16)),
    "turbulence_16x8x32": lambda: turbulence_volume((16, 8, 32), seed=9),
}


def _reference_build(vol):
    """Recursive transliteration; returns {(depth, zmin, ymin, xmin): avg}."""
    Z, Y, X = vol.shape
    min_dim = min(X, Y, Z)
    split_dims = [a for a, n in ((0, X), (1, Y), (2, Z)) if n != min_dim]
    start_depth = sum(int(np.log2(n // min_dim)) for n in (X, Y, Z))
    out = {}

    def rec(depth, mn, mx):
        box = vol[mn[2]:mx[2], mn[1]:mx[1], mn[0]:mx[0]]
        out[(depth, mn[2], mn[1], mn[0])] = int(box.sum(dtype=np.int64) // box.size)
        if box.size == 1:
            return
        if depth < start_depth:
            axis = split_dims[depth % len(split_dims)] if split_dims else 0
            mid = (mn[axis] + mx[axis]) // 2
            b = list(mx)
            b[axis] = mid
            rec(depth + 1, tuple(mn), tuple(b))
            a = list(mn)
            a[axis] = mid
            rec(depth + 1, tuple(a), tuple(mx))
        else:
            mid = [(mn[i] + mx[i]) // 2 for i in range(3)]
            for i in range(8):
                a = [mn[j] if not (i >> j) & 1 else mid[j] for j in range(3)]
                b = [mid[j] if not (i >> j) & 1 else mx[j] for j in range(3)]
                rec(depth + 1, tuple(a), tuple(b))

    rec(0, (0, 0, 0), (X, Y, Z))
    return out


@pytest.mark.parametrize("name", list(VOLUMES))
def test_build_and_level_cuts_equal_jax(name):
    vol = VOLUMES[name]()
    t, j = TO.build(vol), JO.build(vol)
    assert (t.dims, t.start_depth, t.depth, t.split_dims) == \
        (j.dims, j.start_depth, j.depth, j.split_dims)
    assert len(t.level_scalars) == len(j.level_scalars) == t.depth + 1
    for a, b in zip(t.level_scalars, j.level_scalars):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert t.node_count() == j.node_count()
    for d in range(t.depth + 2):  # a cut past the depth clamps to it
        np.testing.assert_array_equal(TO.level_cut(t, d), JO.level_cut(j, d))
    np.testing.assert_array_equal(TO.level_cut(t, t.depth), vol)


@pytest.mark.parametrize("name", list(VOLUMES))
def test_levels_match_recursive_reference(name):
    vol = VOLUMES[name]()
    tree = TO.build(vol)
    ref = _reference_build(vol)
    Z, Y, X = vol.shape
    assert len(ref) == tree.node_count()
    for d, scal in enumerate(tree.level_scalars):
        nz, ny, nx = scal.shape
        bz, by, bx = Z // nz, Y // ny, X // nx
        got = {(d, iz * bz, iy * by, ix * bx): int(scal[iz, iy, ix])
               for iz in range(nz) for iy in range(ny) for ix in range(nx)}
        assert got == {k: v for k, v in ref.items() if k[0] == d}


def test_octree_from_numpy_and_bad_dims():
    vol = VOLUMES["turbulence_16x8x32"]()
    j = JO.build(vol)
    t = octree_from_numpy(**dataclasses.asdict(j))
    for a, b in zip(t.level_scalars, TO.build(vol).level_scalars):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TO.level_cut(t, 3), JO.level_cut(j, 3))
    with pytest.raises(TypeError, match="expected the fields"):
        octree_from_numpy(dims=(1, 1, 1))
    with pytest.raises(ValueError, match="power-of-two"):
        TO.build(np.zeros((6, 6, 6), np.uint8))
