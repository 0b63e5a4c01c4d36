"""The port's ``TimestepStreamer`` against the JAX package's (the
counterpart of tests/test_streaming.py): 8^3 synthetic bricks in a 2x2x2
grid, 4 timesteps, each timestep's 16^2 render within 1e-5 of JAX's (``TOL``;
the frames differ by up to 7.2e-7); the resume pass reads no brick and
renders what the first pass rendered; the checkpoints the port writes are
byte-equal to JAX's; a checkpoint that the level layout cannot hold takes
the raw path in both packages, with equal renders.  On the CPU
(``device="cpu"``), plain renders."""
import struct

import numpy as np
import pytest
import torch

from volumerenderer_tpu import Camera as JCamera
from volumerenderer_tpu import generate_rays as j_generate_rays
from volumerenderer_tpu.io.bricks import BrickGrid as JGrid
from volumerenderer_tpu.io.bricks import synthetic_brick_source as j_source
from volumerenderer_tpu.io.streaming import TimestepStreamer as JStreamer
from volumerenderer_tpu.models.compressed import CompressedRenderer as JCompressed
from volumerenderer_tpu.models.compressed import DenseRenderer as JDense
from volumerenderer_tpu_torch import Camera, generate_rays
from volumerenderer_tpu_torch.io.bricks import BrickGrid, synthetic_brick_source
from volumerenderer_tpu_torch.io.streaming import TimestepStreamer
from volumerenderer_tpu_torch.models.compressed import CompressedRenderer, DenseRenderer

TIMESTEPS = [270, 271, 272, 273]
# The bar tests/test_torch_compressed.py holds CompressedRenderer.render (the
# plain render) to against JAX's.  These frames differ by up to 7.2e-7 (4 of a
# timestep's 768 values lie above 6e-7).
TOL = 1e-5
KW = dict(num_bricks=8, I=2, J=2, K_bricks=2, tolerance=2, max_epochs=1)


def _stream(cache_dir=None, source=None, timesteps=TIMESTEPS, **kw):
    grid = BrickGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))
    rays = generate_rays(Camera(width=16, height=16), device="cpu")
    s = TimestepStreamer(source or synthetic_brick_source(grid), grid, timesteps, **KW,
                         cache_dir=cache_dir, device="cpu", **kw)
    return [(t, r, r.render(rays)[0].numpy()) for t, r in s]


def _jax_stream(cache_dir=None, timesteps=TIMESTEPS, **kw):
    grid = JGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))
    rays = j_generate_rays(JCamera(width=16, height=16))
    s = JStreamer(j_source(grid), grid, timesteps, **KW, cache_dir=cache_dir, **kw)
    return [(t, r, np.asarray(r.render(rays)[0])) for t, r in s]


def test_stream_renders_equal_jax():
    got, want = _stream(prefetch=2), _jax_stream(prefetch=2)
    assert [t for t, _, _ in got] == TIMESTEPS == [t for t, _, _ in want]
    for (_, r, img), (_, _, jimg) in zip(got, want):
        assert isinstance(r, CompressedRenderer) and r.device == torch.device("cpu")
        np.testing.assert_allclose(img, jimg, atol=TOL, rtol=0)
    assert not np.allclose(got[0][2], got[1][2])  # the timesteps differ


def test_resume_reads_no_brick_and_checkpoints_equal_jax(tmp_path):
    (tmp_path / "torch").mkdir()
    (tmp_path / "jax").mkdir()
    first = _stream(str(tmp_path / "torch"))
    _jax_stream(str(tmp_path / "jax"))
    for t in TIMESTEPS:
        name = f"tree_{t:04d}.bin"
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()

    reads = []
    grid = BrickGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))
    src = synthetic_brick_source(grid)

    def counting(b, t):
        reads.append((b, t))
        return src(b, t)

    second = _stream(str(tmp_path / "torch"), source=counting)
    assert not reads
    for (t1, _, a), (t2, r, b) in zip(first, second):
        assert t1 == t2 and isinstance(r, CompressedRenderer)
        np.testing.assert_array_equal(b, a)


def test_unholdable_checkpoint_takes_the_raw_path_as_jax(tmp_path):
    """A header whose X (12) is not a power of two: the level layout cannot
    hold it (``open_tree_full`` raises ``ValueError``), so both packages
    decode the stream sequentially and render it dense."""
    (tmp_path / "torch").mkdir()
    (tmp_path / "jax").mkdir()
    _stream(str(tmp_path / "torch"), timesteps=[271])
    _jax_stream(str(tmp_path / "jax"), timesteps=[271])
    for d in ("torch", "jax"):
        path = tmp_path / d / "tree_0271.bin"
        data = bytearray(path.read_bytes())
        struct.pack_into("<q", data, 24, 12)   # rootMax X
        struct.pack_into("<q", data, 56, 12)   # X
        path.write_bytes(bytes(data))
    (t, r, img), = _stream(str(tmp_path / "torch"), timesteps=[271])
    (jt, jr, jimg), = _jax_stream(str(tmp_path / "jax"), timesteps=[271])
    assert t == jt == 271
    assert isinstance(r, DenseRenderer) and isinstance(jr, JDense)
    assert not isinstance(r, CompressedRenderer) and not isinstance(jr, JCompressed)
    vol = r.volume_at()
    assert tuple(vol.shape) == (16, 16, 12)
    np.testing.assert_array_equal(vol.numpy(), np.asarray(jr.volume_at()))
    np.testing.assert_allclose(img, jimg, atol=TOL, rtol=0)


def test_worker_errors_reach_the_consumer():
    grid = BrickGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))

    def failing(b, t):
        raise OSError(f"brick {b} of timestep {t} is missing")

    s = TimestepStreamer(failing, grid, TIMESTEPS, **KW, device="cpu")
    with pytest.raises(OSError, match="missing"):
        list(s)
