"""The port's brick loader (``io/bricks.py``) against the JAX package's
(``volumerenderer_tpu/io/bricks.py``): grid coordinates and dims, the RM
path template, raw brick files and their size check, both synthetic brick
kinds at 8^3 bricks on a 2x2x2 grid, the assembled volume, and a load whose
bricks fall outside its (I, J, K), which both packages refuse."""
import numpy as np
import pytest

from volumerenderer_tpu.io import bricks as JB
from volumerenderer_tpu_torch.io import bricks as TB


@pytest.mark.parametrize("dims,grid", [((8, 8, 8), (2, 2, 2)), ((256, 256, 128), (8, 8, 15)),
                                       ((16, 8, 4), (3, 1, 2))])
def test_grid_coords_and_dims_equal_jax(dims, grid):
    tg, jg = TB.BrickGrid(dims, grid), JB.BrickGrid(dims, grid)
    assert tg.num_bricks() == jg.num_bricks()
    assert [tg.brick_coords(b) for b in range(tg.num_bricks())] == \
        [jg.brick_coords(b) for b in range(jg.num_bricks())]
    for sub in ((None, None, None), (2, 1, 1), (1, 1, 2)):
        assert tg.volume_dims(*sub) == jg.volume_dims(*sub)


def test_defaults_and_rm_path_equal_jax():
    assert TB.RM_BRICK_DIMS == JB.RM_BRICK_DIMS and TB.RM_VOLUME_GRID == JB.RM_VOLUME_GRID
    assert TB.BrickGrid() == TB.BrickGrid(JB.BrickGrid().brick_dims, JB.BrickGrid().grid)
    for brick, step in ((0, 0), (17, 273), (959, 5)):
        assert TB.rm_brick_path("/data/rm", brick, step) == JB.rm_brick_path("/data/rm", brick,
                                                                            step)


def test_brick_file_roundtrip_and_size_check(tmp_path):
    grid = TB.BrickGrid(brick_dims=(8, 4, 2), grid=(2, 1, 1))
    rng = np.random.default_rng(3)
    bricks = [rng.integers(0, 256, (2, 4, 8)).astype(np.uint8) for _ in range(2)]
    for b, data in enumerate(bricks):
        path = TB.rm_brick_path(str(tmp_path), b, 273)
        (tmp_path / f"bob{273:03d}").mkdir(exist_ok=True)
        data.tofile(path)
        np.testing.assert_array_equal(TB.load_brick_file(path, grid.brick_dims), data)
        np.testing.assert_array_equal(JB.load_brick_file(path, grid.brick_dims), data)
    vol = TB.load_bricks(TB.file_brick_source(str(tmp_path), grid), grid, 2, 2, 1, 1, 273)
    np.testing.assert_array_equal(vol, np.concatenate(bricks, axis=2))
    jgrid = JB.BrickGrid(grid.brick_dims, grid.grid)
    np.testing.assert_array_equal(
        vol, JB.load_bricks(JB.file_brick_source(str(tmp_path), jgrid), jgrid, 2, 2, 1, 1, 273))
    short = tmp_path / "short"
    bricks[0][:1].tofile(short)
    for mod in (TB, JB):
        with pytest.raises(ValueError, match="File size does not match"):
            mod.load_brick_file(str(short), grid.brick_dims)


@pytest.mark.parametrize("kind", ["turbulence", "sphere"])
def test_synthetic_bricks_and_assembly_equal_jax(kind):
    tg = TB.BrickGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))
    jg = JB.BrickGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))
    ts, js = TB.synthetic_brick_source(tg, kind), JB.synthetic_brick_source(jg, kind)
    for b in range(8):
        a, w = ts(b, 273), js(b, 273)
        assert a.dtype == w.dtype == np.uint8 and a.shape == (8, 8, 8)
        np.testing.assert_array_equal(a, w)
    got = TB.load_bricks(ts, tg, 8, 2, 2, 2, 273)
    want = JB.load_bricks(js, jg, 8, 2, 2, 2, 273)
    assert got.shape == (16, 16, 16) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # brick b's block is where (i, j, k) puts it, i fastest
    i, j, k = tg.brick_coords(5)
    np.testing.assert_array_equal(got[8 * k:8 * k + 8, 8 * j:8 * j + 8, 8 * i:8 * i + 8],
                                  ts(5, 273))
    out = np.zeros((16, 16, 16), dtype=np.uint8)
    assert TB.assemble_bricks(ts, tg, 8, 2, 2, 2, 273, out=out) is out
    np.testing.assert_array_equal(out, want)


def test_bricks_outside_the_load_raise_in_both():
    """The default RM grid (8, 8, 15) loaded as 2x2x2: brick 2 sits at
    i = 2, outside I = 2.  The port names the brick and both grids; JAX
    fails in numpy's broadcast."""
    tg = TB.BrickGrid(brick_dims=(4, 4, 4))
    jg = JB.BrickGrid(brick_dims=(4, 4, 4))
    with pytest.raises(ValueError, match=r"brick 2 .*\(8, 8, 15\).*\(2, 2, 2\)"):
        TB.load_bricks(TB.synthetic_brick_source(tg), tg, 8, 2, 2, 2, 273)
    with pytest.raises(ValueError):
        JB.load_bricks(JB.synthetic_brick_source(jg), jg, 8, 2, 2, 2, 273)
    # within the grid's first row the same load is fine in both
    got = TB.load_bricks(TB.synthetic_brick_source(tg), tg, 2, 2, 1, 1, 273)
    np.testing.assert_array_equal(got, JB.load_bricks(JB.synthetic_brick_source(jg), jg, 2, 2,
                                                      1, 1, 273))
