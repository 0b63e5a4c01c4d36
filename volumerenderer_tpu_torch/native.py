"""ctypes binding of the kd-tree codec's native host passes
(``csrc/kdtree_native.cu``).

Counterpart of the ``kdtree_native`` class of
``volumerenderer_tpu/native/__init__.py``: the preorder decode, the full
build for any dimensions and the inverse preorder walk, each equal to its
Python version (``codecs/reference_impl.py``, ``codecs/kdtree.py``) array
for array.  The library is built with ``nvcc`` (host code only) at first
use, like the kernels, into the package's ``build/``; a failed build raises.
The JAX package falls back to Python on any ``OSError`` of its build; here
the callers choose (``use_native``), and a native call that cannot build
does not turn into a Python one.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from .utils.bitarray import pack2_np

__all__ = ["kdtree_native"]

_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    from .ops.cuda import _build

    lib = _build.load("kdtree_native").lib
    lib.set_native_threads.argtypes = [ctypes.c_int32]
    lib.set_native_threads.restype = None
    lib.decode_preorder_native.argtypes = [_P, ctypes.c_int64, _P, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                                           ctypes.c_int32, ctypes.c_int32, _P]
    lib.decode_preorder_native.restype = ctypes.c_int32
    lib.build_full_native.argtypes = [_P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_int32, _P, _P, _P]
    lib.build_full_native.restype = ctypes.c_int64
    lib.preorder_to_levels_native.argtypes = [_P, ctypes.c_int64, ctypes.c_int32,
                                              ctypes.c_int32, _P, _P, ctypes.c_int32]
    lib.preorder_to_levels_native.restype = ctypes.c_int32
    return lib


def _num_max_nodes(orig_depth: int, max_depth: int) -> int:
    """The most preorder nodes a tree of these depths can emit: the full tree
    and one chain of max_depth - orig_depth nodes under every leaf."""
    return ((1 << (orig_depth + 1)) - 1) + (1 << orig_depth) * (max_depth - orig_depth)


def _packed_stream(preorder: np.ndarray) -> np.ndarray:
    preorder = np.asarray(preorder, dtype=np.uint8).ravel()
    if preorder.size == 0:
        raise ValueError("an empty preorder stream")
    return np.ascontiguousarray(pack2_np(preorder))


class kdtree_native:
    """The native passes, named as in the JAX package's binding."""

    @staticmethod
    def set_threads(n: int) -> None:
        """Cap the build's fork-join parallelism (default: every core); the
        trees are the same at any thread count."""
        _lib().set_native_threads(int(n))

    @staticmethod
    def decode_preorder(preorder: np.ndarray, distance_map: np.ndarray, X: int, Y: int, Z: int,
                        orig_depth: int, max_depth: int, cut_depth: int) -> np.ndarray:
        """``reference_impl.decode_preorder`` of an unpacked preorder stream:
        the (Z, Y, X) uint8 volume.  A stream that ends inside the tree
        raises ``ValueError``."""
        packed = _packed_stream(preorder)
        dm = np.ascontiguousarray(distance_map, dtype=np.uint8)
        if dm.shape != (max_depth + 1,):
            raise ValueError(f"distance map of {dm.shape}, expected ({max_depth + 1},)")
        out = np.zeros(X * Y * Z, dtype=np.uint8)
        rc = _lib().decode_preorder_native(packed.ctypes.data, len(preorder), dm.ctypes.data,
                                           X, Y, Z, orig_depth, max_depth, cut_depth,
                                           out.ctypes.data)
        if rc != 0:
            raise ValueError("the preorder stream ends inside the tree")
        return out.reshape(Z, Y, X)

    @staticmethod
    def build_full(volume: np.ndarray, tolerance: int, max_epochs: int, orig_depth: int,
                   max_depth: int, distance_map: np.ndarray):
        """The full sequential build of a (Z, Y, X) uint8 volume of any
        dimensions.  ``distance_map`` (max_depth + 1,) must hold the extra
        levels' ladder; a filled copy is returned.  Returns (num_active,
        packed preorder, distance map, leaf recon)."""
        vol = np.ascontiguousarray(volume, dtype=np.uint8)
        if vol.ndim != 3:
            raise ValueError(f"expected a (Z, Y, X) volume, got {vol.shape}")
        Z, Y, X = vol.shape
        dm = np.array(distance_map, dtype=np.uint8)
        if dm.shape != (max_depth + 1,):
            raise ValueError(f"distance map of {dm.shape}, expected ({max_depth + 1},)")
        packed = np.zeros((_num_max_nodes(orig_depth, max_depth) + 3) // 4, dtype=np.uint8)
        leaf_recon = np.zeros(1 << orig_depth, dtype=np.int32)
        n_active = _lib().build_full_native(vol.ctypes.data, X, Y, Z, tolerance, max_epochs,
                                            orig_depth, max_depth, dm.ctypes.data,
                                            packed.ctypes.data, leaf_recon.ctypes.data)
        return int(n_active), packed, dm, leaf_recon

    @staticmethod
    def preorder_to_levels(preorder: np.ndarray, orig_depth: int, max_depth: int):
        """The level-structured layout of an unpacked preorder stream:
        (levels_flat, level d at offset 2^d - 1, unvisited slots 3; chains
        (2^orig_depth, max_depth - orig_depth), unvisited slots 255).  A
        stream that ends inside the tree raises ``ValueError``."""
        packed = _packed_stream(preorder)
        chain_len = max_depth - orig_depth
        levels_flat = np.full((1 << (orig_depth + 1)) - 1, 3, dtype=np.uint8)
        chains = np.full((1 << orig_depth, chain_len), 255, dtype=np.uint8)
        rc = _lib().preorder_to_levels_native(packed.ctypes.data, len(preorder), orig_depth,
                                              max_depth, levels_flat.ctypes.data,
                                              chains.ctypes.data, chain_len)
        if rc != 0:
            raise ValueError("the preorder stream ends inside the tree")
        return levels_flat, chains
