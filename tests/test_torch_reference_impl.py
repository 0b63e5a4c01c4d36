"""The port's sequential kd-tree codec (``codecs/reference_impl.py``)
against the JAX package's, on seeded turbulences of 4^3 and 12x10x6 (the
latter not a power of two on any axis): ``SequentialKdTree`` array for
array, the Python ``decode_preorder`` at a cut below ``max_depth`` and at
it, ``build_arbitrary`` in Python against JAX's (which runs its prebuilt
native library here), and ``use_native=True`` raising without nvcc.  All
exact.  The native passes are held to these on the card
(tests/test_torch_codecs_cuda.py)."""
import shutil

import numpy as np
import pytest

from volumerenderer_tpu.codecs import reference_impl as JR
from volumerenderer_tpu.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch import native
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.codecs import reference_impl as TR
from volumerenderer_tpu_torch.ops.cuda import _build

SHAPES = {"4x4x4": (4, 4, 4), "12x10x6": (6, 10, 12)}  # (Z, Y, X)


@pytest.fixture(scope="module", params=list(SHAPES))
def volume(request):
    return turbulence_volume(SHAPES[request.param], seed=17)


def _built(mod, vol, tolerance=3, max_epochs=3):
    Z, Y, X = vol.shape
    tree = mod.SequentialKdTree(vol.reshape(-1), X, Y, Z, tolerance, max_epochs)
    tree.build()
    return tree


def test_sequential_tree_equals_jax(volume):
    got, want = _built(TR, volume), _built(JR, volume)
    assert (got.orig_depth, got.max_depth, got.num_active_nodes) == \
        (want.orig_depth, want.max_depth, want.num_active_nodes)
    for name in ("distance_map", "preorder", "recon", "tree", "temp"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for cut in (got.orig_depth - 1, got.max_depth):
        np.testing.assert_array_equal(got.level_cut(cut, use_native=False),
                                      want.level_cut(cut))


def test_decode_preorder_equals_jax(volume):
    tree = _built(TR, volume)
    Z, Y, X = volume.shape
    args = (tree.preorder, tree.distance_map, X, Y, Z, tree.orig_depth, tree.max_depth)
    for cut in (tree.orig_depth - 2, tree.max_depth):
        got = TR.decode_preorder(*args, cut, use_native=False)
        assert got.shape == volume.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, JR.decode_preorder(*args, cut, use_native=False))


def test_sequential_tree_equals_vectorized_codec():
    """On power-of-two dims the sequential codec and ``kdtree.build`` write
    one stream."""
    vol = turbulence_volume((8, 8, 16), seed=4)
    seq = _built(TR, vol, tolerance=2, max_epochs=2)
    vec = TK.build(vol, tolerance=2, max_epochs=2)
    np.testing.assert_array_equal(seq.preorder, TK.to_preorder(vec))
    np.testing.assert_array_equal(seq.distance_map, vec.distance_map)
    np.testing.assert_array_equal(seq.level_cut(seq.max_depth, use_native=False),
                                  TK.level_cut(vec))


def test_build_arbitrary_python_equals_jax(volume):
    got = TR.build_arbitrary(volume, tolerance=3, max_epochs=3, use_native=False)
    want = JR.build_arbitrary(volume, tolerance=3, max_epochs=3)
    assert (got.orig_depth, got.max_depth, got.num_active_nodes) == \
        (want.orig_depth, want.max_depth, want.num_active_nodes)
    for name in ("distance_map", "preorder", "recon"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("call", ["build_arbitrary", "decode_preorder", "preorder_to_levels"])
def test_use_native_raises_without_nvcc(call, volume, tmp_path, monkeypatch):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is on PATH here; the native build is tested on the card")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)   # no earlier build to load
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / f"lib{name}-none.so")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    native._lib.cache_clear()
    tree = _built(TR, volume)
    Z, Y, X = volume.shape
    calls = {
        "build_arbitrary": lambda: TR.build_arbitrary(volume, use_native=True),
        "decode_preorder": lambda: TR.decode_preorder(
            tree.preorder, tree.distance_map, X, Y, Z, tree.orig_depth, tree.max_depth,
            tree.max_depth, use_native=True),
        "preorder_to_levels": lambda: TK.preorder_to_levels(
            TK.to_preorder(TK.build(turbulence_volume((8, 8, 8), seed=1))), 9, 16,
            use_native=True)}
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            calls[call]()
    finally:
        native._lib.cache_clear()


def test_truncated_stream_raises(volume):
    tree = _built(TR, volume)
    Z, Y, X = volume.shape
    with pytest.raises(ValueError, match="ends inside the tree"):
        TR.decode_preorder(tree.preorder[:len(tree.preorder) // 2], tree.distance_map, X, Y, Z,
                           tree.orig_depth, tree.max_depth, tree.max_depth, use_native=False)
