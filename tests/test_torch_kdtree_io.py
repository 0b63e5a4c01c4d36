"""The port's kd-tree and mid-range checkpoint I/O against the JAX
package's, on a 16^3 turbulence and an 8^3 sphere (numpy, seeded): equal
preorder streams, byte-equal files, each package opening the other's file,
the inverse walk (the Python one here; the native one is held to it on the
card in tests/test_torch_codecs_cuda.py), ``query_error``, and the mid-range
file and texture layouts.  Everything is exact: equal arrays and bytes."""
import dataclasses

import numpy as np
import pytest

from volumerenderer_tpu.codecs import kdtree as JK
from volumerenderer_tpu.codecs import midrange as JM
from volumerenderer_tpu.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.codecs import midrange as TM
from volumerenderer_tpu_torch.utils.bitarray import pack2_np

VOLUMES = {"turbulence16": lambda: turbulence_volume((16, 16, 16), seed=21),
           "sphere8": lambda: sphere_volume((8, 8, 8))}


@pytest.fixture(scope="module", params=list(VOLUMES))
def trees(request):
    vol = VOLUMES[request.param]()
    return vol, JK.build(vol, tolerance=2, max_epochs=2), TK.build(vol, tolerance=2, max_epochs=2)


def _assert_same_tree(got, want):
    assert tuple(got.dims) == tuple(want.dims)
    assert (got.orig_depth, got.max_depth, got.num_active_nodes) == \
        (want.orig_depth, want.max_depth, want.num_active_nodes)
    assert list(got.schedule) == list(want.schedule)
    np.testing.assert_array_equal(got.distance_map, want.distance_map)
    assert len(got.level_codes) == len(want.level_codes)
    for a, b in zip(got.level_codes, want.level_codes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.chain_codes, want.chain_codes)


def test_to_preorder_equals_jax(trees):
    _, jt, tt = trees
    pre = TK.to_preorder(tt)
    assert pre.dtype == np.uint8 and len(pre) == tt.num_active_nodes
    np.testing.assert_array_equal(pre, JK.to_preorder(jt))


def test_save_writes_jax_bytes(trees, tmp_path):
    _, jt, tt = trees
    JK.save(jt, tmp_path / "jax.bin")
    TK.save(tt, tmp_path / "torch.bin")
    assert (tmp_path / "torch.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def test_each_package_opens_the_others_file(trees, tmp_path):
    _, jt, tt = trees
    JK.save(jt, tmp_path / "jax.bin")
    TK.save(tt, tmp_path / "torch.bin")
    for a, b in (("torch.bin", "jax.bin"), ("jax.bin", "torch.bin")):
        j_raw, t_raw = JK.open_tree(tmp_path / a), TK.open_tree(tmp_path / b)
        assert j_raw.keys() == t_raw.keys()
        for k in j_raw:
            np.testing.assert_array_equal(np.asarray(t_raw[k]), np.asarray(j_raw[k]), err_msg=k)
    # the full trees: the port's from JAX's file, JAX's from the port's
    _assert_same_tree(TK.open_tree_full(tmp_path / "jax.bin", use_native=False), tt)
    _assert_same_tree(JK.open_tree_full(tmp_path / "torch.bin"), jt)


def test_preorder_to_levels_and_open_tree_full_equal_jax(trees, tmp_path):
    _, jt, tt = trees
    pre = TK.to_preorder(tt)
    levels, chains = TK.preorder_to_levels(pre, tt.orig_depth, tt.max_depth, use_native=False)
    j_levels, j_chains = JK.preorder_to_levels(pre, jt.orig_depth, jt.max_depth)
    for a, b in zip(levels, j_levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(chains, j_chains)
    TK.save(tt, tmp_path / "t.bin")
    got = TK.open_tree_full(tmp_path / "t.bin", use_native=False)
    want = JK.open_tree_full(tmp_path / "t.bin")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, list) and b and isinstance(b[0], np.ndarray):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
    np.testing.assert_array_equal(TK.level_cut(got), TK.level_cut(tt))


def structural_flip(pre: np.ndarray, orig_depth: int, max_depth: int) -> np.ndarray:
    """The stream with its first code flipped between 3 and not-3 such that
    the walk still ends inside the stream (so every package's walk, the JAX
    package's native one too, stays in bounds) but the rebuilt tree no
    longer serializes to it."""
    for i in range(1, len(pre)):
        bad = pre.copy()
        bad[i] = 0 if pre[i] == 3 else 3
        try:
            TK.preorder_to_levels(bad, orig_depth, max_depth, use_native=False)
        except ValueError:
            continue
        return bad
    raise AssertionError("no flip keeps the walk inside the stream")


def test_open_tree_full_raises_on_flipped_code(trees, tmp_path):
    _, _, tt = trees
    TK.save(tt, tmp_path / "t.bin")
    raw = TK.open_tree(tmp_path / "t.bin")
    bad = structural_flip(raw["preorder"], tt.orig_depth, tt.max_depth)
    data = bytearray((tmp_path / "t.bin").read_bytes())
    off = TK.FILE_HEADER.size + tt.max_depth + 1
    data[off:] = pack2_np(bad).tobytes()
    (tmp_path / "bad.bin").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="round-trip"):
        TK.open_tree_full(tmp_path / "bad.bin", use_native=False)
    with pytest.raises(ValueError, match="round-trip"):
        JK.open_tree_full(tmp_path / "bad.bin")
    # verify=False accepts the stream as it is
    TK.open_tree_full(tmp_path / "bad.bin", verify=False, use_native=False)


def test_truncated_stream_and_short_file_raise(trees, tmp_path):
    _, _, tt = trees
    pre = TK.to_preorder(tt)
    with pytest.raises(ValueError, match="ends inside the tree"):
        TK.preorder_to_levels(pre[:len(pre) // 2], tt.orig_depth, tt.max_depth, use_native=False)
    TK.save(tt, tmp_path / "t.bin")
    data = (tmp_path / "t.bin").read_bytes()
    (tmp_path / "short.bin").write_bytes(data[:-2])
    with pytest.raises(ValueError, match="shorter"):
        TK.open_tree(tmp_path / "short.bin")


def test_query_error_equals_jax(trees):
    vol, jt, tt = trees
    for cut in (tt.orig_depth - 3, tt.max_depth):
        dec = TK.level_cut(tt, cut)
        got = TK.query_error(dec, vol)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, JK.query_error(JK.level_cut(jt, cut), vol))


def test_midrange_io_equals_jax(trees, tmp_path):
    vol = trees[0]
    jm = JM.build(vol, tolerance=2, max_epochs=2)
    tm = TM.build(vol, tolerance=2, max_epochs=2)
    for a, b in zip(TM.to_preorder_pair(tm), JM.to_preorder_pair(jm)):
        np.testing.assert_array_equal(a, b)
    JM.save(jm, tmp_path / "jax.bin")
    TM.save(tm, tmp_path / "torch.bin")
    assert (tmp_path / "torch.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    got, want = TM.open_tree(tmp_path / "jax.bin"), JM.open_tree(tmp_path / "torch.bin")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    layout = TM.convert_to_byte_array(tm)
    np.testing.assert_array_equal(layout, JM.convert_to_byte_array(jm))
    assert layout.size & (layout.size - 1) == 0
