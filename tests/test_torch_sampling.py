"""Port trilinear sampling vs the JAX package's ``sample_trilinear``.

Both take the same taps and run the same three lerp stages in float32 with
no fused multiply-add; 1e-7 leaves room for one rounding difference."""
import numpy as np
import pytest
import torch

from volumerenderer_tpu.ops import sampling as J
from volumerenderer_tpu_torch.ops import sampling as T

SHAPE = (8, 16, 12)  # (Z, Y, X), all extents different


def _volume():
    rng = np.random.default_rng(21)
    return np.round(rng.random(SHAPE) * 255.0).astype(np.uint8)


def _uvw():
    rng = np.random.default_rng(22)
    inner = rng.random((500, 3)).astype(np.float32)
    # texel centers, cell edges, the faces, half a texel either side of them,
    # and points just outside the cube (clamped or wrapped)
    Z, Y, X = SHAPE
    dims = np.array([X, Y, Z], np.float32)
    ticks = [0.0, 1e-6, 0.5, 1.0 - 1e-6, 1.0, -0.02, 1.03]
    edge = [np.array([a, b, c], np.float32) for a in ticks for b in ticks for c in ticks[:4]]
    centers = (np.array([[0, 0, 0], [1, 2, 3], [11, 15, 7]], np.float32) + 0.5) / dims
    halves = np.concatenate([0.5 / dims[None], 1.0 - 0.5 / dims[None]], axis=0)
    return np.concatenate([inner, np.stack(edge), centers, halves]).astype(np.float32)


def test_as_normalized_volume_exact():
    v = _volume()
    ours = T.as_normalized_volume(v, device="cpu")
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(J.as_normalized_volume(v)))
    f = np.random.default_rng(1).random(SHAPE).astype(np.float32)
    np.testing.assert_array_equal(T.as_normalized_volume(torch.from_numpy(f)).numpy(), f)


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_sample_trilinear_matches_jax(wrap):
    v = _volume()
    uvw = _uvw()
    ours = T.sample_trilinear(T.as_normalized_volume(v, device="cpu"), torch.from_numpy(uvw),
                              wrap=wrap)
    ref = J.sample_trilinear(J.as_normalized_volume(v), uvw, wrap=wrap)
    assert ours.shape == (uvw.shape[0],)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-7, rtol=0)


def test_sample_trilinear_rejects_unknown_wrap():
    with pytest.raises(ValueError, match="wrap"):
        T.sample_trilinear(torch.zeros(SHAPE), torch.zeros(4, 3), wrap="mirror")
