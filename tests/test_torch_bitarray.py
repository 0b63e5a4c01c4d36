"""The port's packed 2-bit code arrays against the JAX package's, on seeded
random bytes and codes: equal arrays, element for element."""
import numpy as np
import pytest
import torch

from volumerenderer_tpu.utils import bitarray as JB
from volumerenderer_tpu_torch.utils import bitarray as TB


@pytest.mark.parametrize("shape", [(1,), (37,), (4, 9), (3, 2, 5)])
def test_unpack2_matches_jax(shape):
    packed = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(JB.unpack2(packed))
    got = TB.unpack2(torch.from_numpy(packed))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1001])
def test_pack2_np_and_unpack2_np_match_jax(n):
    codes = np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8)
    packed = TB.pack2_np(codes)
    np.testing.assert_array_equal(packed, JB.pack2_np(codes))
    assert packed.shape == (TB.packed2_nbytes(n),) == (JB.packed2_nbytes(n),)
    np.testing.assert_array_equal(TB.unpack2_np(packed, n), codes)
    np.testing.assert_array_equal(TB.unpack2_np(packed), JB.unpack2_np(packed))
    # the device unpack reads the host pack
    np.testing.assert_array_equal(TB.unpack2(torch.from_numpy(packed)).numpy()[:n], codes)


def test_unpack2_rejects_non_bytes():
    with pytest.raises(ValueError, match="uint8"):
        TB.unpack2(torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000])
def test_pack4_np_and_unpack4_np_match_jax(n):
    vals = np.random.default_rng(n + 7).integers(0, 256, n, dtype=np.uint8)  # high bits dropped
    packed = TB.pack4_np(vals)
    np.testing.assert_array_equal(packed, JB.pack4_np(vals))
    np.testing.assert_array_equal(TB.unpack4_np(packed, n), JB.unpack4_np(packed, n))
    np.testing.assert_array_equal(TB.unpack4_np(packed, n), vals & 0xF)
    np.testing.assert_array_equal(TB.unpack4_np(packed), JB.unpack4_np(packed))


@pytest.mark.parametrize("shape", [(4,), (8, 12), (2, 3, 16)])
def test_device_pack2_pack4_unpack4_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    vals = rng.integers(0, 256, shape, dtype=np.uint8)
    t = torch.from_numpy(vals)
    for got, want in ((TB.pack2(t), JB.pack2(vals)), (TB.pack4(t), JB.pack4(vals)),
                      (TB.unpack4(t), JB.unpack4(vals))):
        want = np.asarray(want)
        assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    # the device packs write the host packs' bytes
    np.testing.assert_array_equal(TB.pack2(t).numpy().ravel(), TB.pack2_np(vals))
    np.testing.assert_array_equal(TB.pack4(t).numpy().ravel(), TB.pack4_np(vals))


@pytest.mark.parametrize("fn", ["pack2", "pack4", "unpack4"])
def test_device_packs_reject_non_bytes(fn):
    with pytest.raises(ValueError, match="uint8"):
        getattr(TB, fn)(torch.zeros(4, dtype=torch.int32))
