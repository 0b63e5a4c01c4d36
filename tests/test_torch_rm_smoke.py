"""The port's RM smoke test (``scripts/torch_rm_smoke.py``) against the JAX
package's steps (``scripts/rm_smoke.py``), on brick files the test writes in
the RM layout (``bob273/d_0273_000b``): 8 turbulence bricks of 32x32x16 on the
RM grid of 8x8x15 bricks, loaded as the first 8 of a row, (8, 1, 1).

The assembly and its CRC32 equal JAX's ``io.bricks.load_bricks``; the codec's
leaf-cut errors and active nodes equal JAX's ``kdtree.build`` +
``level_cut`` at the reference's settings (tolerance 1, 2 epochs); the plain
frame equals JAX's jnp render at 48^2, byte for byte in uint8.  A missing
file returns 1, a short file raises ``ValueError``, ``--grid 2,2,2`` raises
the loader's ``ValueError`` naming the brick, and a grid of other than
``--bricks`` bricks raises ``ValueError``."""
import os
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from volumerenderer_tpu import Camera as JCamera
from volumerenderer_tpu import as_normalized_volume as j_normalized
from volumerenderer_tpu import generate_rays as j_rays
from volumerenderer_tpu.codecs import kdtree as JK
from volumerenderer_tpu.io import bricks as JB
from volumerenderer_tpu.ops.raycast import render_compositing as j_render

from volumerenderer_tpu_torch.io import bricks as TB

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import torch_render_demo as demo  # noqa: E402
import torch_rm_smoke as smoke  # noqa: E402

BRICK, TIMESTEP = (32, 32, 16), 273
GRID = TB.BrickGrid(brick_dims=BRICK, grid=TB.RM_VOLUME_GRID)


@pytest.fixture(scope="module")
def rm_dir(tmp_path_factory):
    """8 bricks in the RM layout, turbulence seeded by (timestep, brick)."""
    top = tmp_path_factory.mktemp("rm")
    source = TB.synthetic_brick_source(GRID)
    os.makedirs(top / f"bob{TIMESTEP:03d}")
    for b in range(8):
        source(b, TIMESTEP).tofile(TB.rm_brick_path(str(top), b, TIMESTEP))
    return str(top)


@pytest.fixture(scope="module")
def assembled(rm_dir):
    return smoke.assemble(rm_dir, 8, smoke.parse_grid("8,1,1", 8), TIMESTEP, GRID)


def _jax_load(rm_dir):
    grid = JB.BrickGrid(brick_dims=BRICK, grid=JB.RM_VOLUME_GRID)
    return JB.load_bricks(JB.file_brick_source(rm_dir, grid), grid, 8, 8, 1, 1, TIMESTEP)


def test_assembly_and_crc32_equal_jax(rm_dir, assembled):
    assert smoke.discover(rm_dir, 8, TIMESTEP) == []
    want = _jax_load(rm_dir)
    assert assembled.shape == want.shape == (16, 32, 256) and assembled.dtype == np.uint8
    np.testing.assert_array_equal(assembled, want)
    assert smoke.volume_crc32(assembled) == zlib.crc32(want.tobytes())


def test_codec_round_trip_equals_jax(assembled):
    got = smoke.codec_round_trip(assembled)
    tree = JK.build(assembled, tolerance=1, max_epochs=2)
    rec = JK.level_cut(tree, tree.orig_depth)
    err = np.abs(rec.astype(np.int32) - assembled.astype(np.int32))
    assert got["max_err"] == int(err.max())
    assert got["mean_err"] == pytest.approx(float(err.mean()), rel=1e-12)
    assert got["active_nodes"] == tree.num_active_nodes and got["depth"] == tree.orig_depth


def test_plain_frame_equals_jax(assembled):
    rgb, alpha = smoke.render_frame(assembled, "cpu", size=48)
    rays = j_rays(JCamera(width=48, height=48))
    want, want_alpha = j_render(j_normalized(assembled), rays.entry_uv, rays.direction, rays.hit)
    assert rgb.device.type == "cpu" and tuple(rgb.shape) == (48, 48, 3)
    assert float(np.asarray(want_alpha).max()) > 0.5  # the frame composites something
    np.testing.assert_array_equal(demo.to_uint8(rgb), demo.to_uint8(np.asarray(want)))


def test_main_runs_every_step(rm_dir, assembled, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(smoke, "RM_GRID", GRID)
    monkeypatch.setattr(smoke, "FRAME_SIZE", 32)
    assert smoke.main(["--rm-dir", rm_dir, "--render", "--device", "cpu",
                       "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"found 8 brick files for timestep {TIMESTEP}" in out
    assert f"CRC32 0x{smoke.volume_crc32(assembled):08x}" in out and "codec leaf cut" in out
    frame = np.load(tmp_path / "rm_frame.npy")
    rgb, _ = smoke.render_frame(assembled, "cpu", size=32)
    np.testing.assert_array_equal(frame, rgb.numpy())


def test_missing_file_returns_1(rm_dir, tmp_path, capsys):
    """Discovery runs before any load: one brick short of 9 asked for."""
    assert smoke.main(["--rm-dir", rm_dir, "--bricks", "9", "--grid", "9,1,1",
                       "--no-codec"]) == 1
    missing = TB.rm_brick_path(rm_dir, 8, TIMESTEP)
    assert f"MISSING 1 brick files, e.g. {missing}" in capsys.readouterr().out
    assert smoke.main(["--rm-dir", str(tmp_path), "--no-codec"]) == 1
    assert "MISSING 8 brick files" in capsys.readouterr().out


def test_short_file_raises(rm_dir, tmp_path, monkeypatch):
    short = tmp_path / f"bob{TIMESTEP:03d}"
    short.mkdir()
    for b in range(8):
        data = np.fromfile(TB.rm_brick_path(rm_dir, b, TIMESTEP), np.uint8)
        (data[:-1] if b == 5 else data).tofile(TB.rm_brick_path(str(tmp_path), b, TIMESTEP))
    monkeypatch.setattr(smoke, "RM_GRID", GRID)
    with pytest.raises(ValueError, match="File size does not match.*d_0273_0005"):
        smoke.main(["--rm-dir", str(tmp_path), "--no-codec"])
    # the RM brick size itself: every small brick is short of 256x256x128
    monkeypatch.setattr(smoke, "RM_GRID", TB.BrickGrid())
    with pytest.raises(ValueError, match="expected 8388608"):
        smoke.main(["--rm-dir", rm_dir, "--no-codec"])


def test_grid_outside_the_load_raises(rm_dir, monkeypatch):
    """The JAX script's default --grid 2,2,2 on the RM grid: brick 2 sits at
    i = 2, outside I = 2 (JAX fails in a numpy broadcast)."""
    monkeypatch.setattr(smoke, "RM_GRID", GRID)
    with pytest.raises(ValueError, match=r"brick 2 sits at \(i, j, k\) = \(2, 0, 0\).*"
                                         r"\(8, 8, 15\).*\(2, 2, 2\)"):
        smoke.main(["--rm-dir", rm_dir, "--grid", "2,2,2", "--no-codec"])


@pytest.mark.parametrize("grid,bricks", [("2,2,1", 8), ("8,1,1", 4), ("3,1,1", 2)])
def test_grid_not_of_bricks_raises(rm_dir, grid, bricks):
    with pytest.raises(ValueError, match=f"--grid {grid} holds"):
        smoke.main(["--rm-dir", rm_dir, "--grid", grid, "--bricks", str(bricks), "--no-codec"])


def test_defaults_are_the_reference_settings():
    assert smoke.RM_GRID == TB.BrickGrid((256, 256, 128), (8, 8, 15))
    assert (smoke.CODEC_TOLERANCE, smoke.CODEC_EPOCHS, smoke.FRAME_SIZE) == (1, 2, 1024)
    args = vars(smoke.parser().parse_args(["--rm-dir", "d"]))
    assert args == {"rm_dir": "d", "timestep": 273, "bricks": 8, "grid": "8,1,1",
                    "no_codec": False, "render": False, "device": "cuda", "out": "out"}
