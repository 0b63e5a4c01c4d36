"""Morton-hashed kd-tree codec: the reference ``HashedKdtree``
(``HashedKdtree.cpp``; outside the reference's build, SURVEY.md §2), built on
the host and decoded on the tree's device.

Counterpart of ``volumerenderer_tpu/codecs/hashed.py`` (``HashedKdTree`` :50,
``_deterministic_child`` :79, ``_Builder`` :86, ``build`` :295,
``level_cut`` :356, ``save`` :399, ``open_tree`` :419, the device decode
:450-612) and of its native builder ``native/hashed_native.cpp``.

Structure (citations into ``HashedKdtree.{h,cpp}``):

* nodes are addressed by Morton code: root ``1``, children ``(m<<1)|{0,1}``
  (``:12-18``); the hash is ``mcode & hashMask`` with ``hashMask = 2^D − 1``
  (``:8-10,35-36``), deliberately undersized, so every depth-D leaf aliases
  an interior node;
* two 2-bit tables: ``treeData`` (Δ codes; 3 = collision sentinel in the
  main table) and ``treeStructure`` (0 leaf / 1 left / 2 right / 3 both,
  ``HashedKdtree.h:36-37``); a colliding node evicts the slot's owner into
  side arrays reached through an ``mcode -> idx`` map (``:126-166``);
* pass 1 builds depth first, left first (the visit order decides who owns a
  slot), summing per depth the chosen branch's *residual* error (``:381,395``)
  with the running-mean candidate ``(sums[d]+pd)/(counts[d]+1)``
  (``:350-351``); ``distanceMap[d] = (byte)(sums/counts)`` truncates (``:60``);
* pass 2 re-encodes with the map; a leaf with any error above the original
  depth splits into both children; an error above the tolerance grows ONE
  child, for up to ``maxAddLevels = 4`` levels with Δ = 64, 32, 16, 8
  (``:487-494``).  The reference picks that child by ``std::shuffle``
  seeded from ``random_device`` (``:473``); both packages pick it by a
  64-bit wrapping multiply of the Morton code instead
  (:func:`_deterministic_child`, the same in Python and C++).

The builder is sequential, so it runs on the host: in the Python
:class:`_Builder` (a copy of JAX's, traversal order included), or in
``csrc/hashed_build.cu``, a host-only copy of the native builder built with
``nvcc`` at first use and loaded with ctypes.  :func:`build` takes the
native one on a machine with a CUDA device, where a failed build raises, and
the Python one elsewhere; ``use_native`` forces either.  The JAX package
gives way to the Python builder on any ``OSError`` of its native build
(``volumerenderer_tpu/codecs/hashed.py:297-301``); the port never falls back
silently.

The device decode (:func:`to_device_hashed`, :func:`level_cut_device_hashed`)
computes what JAX's does (``:467-612``): per level a gather into the main
table, collisions resolved by ``torch.searchsorted`` into the sorted
collision keys, the sweep's ``terminal``/``frozen``/``filled`` states, the
grown unary chains below the original depth, and the leaves put into volume
order on the device.  It differs in three ways:

* Morton codes are int64 at every depth.  JAX carries uint32 codes and
  refuses a cut deeper than 31 without x64 (``:487-493``); here nothing is
  refused;
* trees of depth ``>= device.CHUNKED_DECODE_MIN_DEPTH`` decode per depth-K
  subtree of 2^``CHUNK_LEAF_BITS`` leaves, as ``codecs/device.py`` decodes
  the kd-tree; each chunk follows its own chains, and consecutive chunks go
  in groups of 2^``GROUP_LEAF_BITS`` leaves, the most any intermediate
  holds.  JAX decodes every level at once, and compiles a sweep per cut
  (``:592-600``);
* each node's code and structure are one byte (``code | structure << 2``),
  the collision bytes stored in key order, and each depth searches only the
  keys of its own depth (codes at depth d lie in [2^d, 2^(d+1))).  For every
  node the decode visits, the byte is the one JAX gathers.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..utils.bitarray import pack2_np, unpack2_np
from . import device as _dev
from .kdtree import leaves_to_volume, split_schedule, volume_to_leaves

__all__ = ["HashedKdTree", "build", "level_cut", "save", "open_tree", "DeviceHashedKdTree",
           "to_device_hashed", "level_cut_device_hashed", "collision_capacity"]

MAX_ADD_LEVELS = 4       # HashedKdtree.h:81
ADD_LEVEL_START = 64     # HashedKdtree.h:80
DEFAULT_TOLERANCE = 4    # HashedKdtree.h:79 (constructor)
# leaves a group of chunks decodes together: a level costs ~35 torch
# operations per group whatever its size, so the 256^3 decode (2^24 leaves)
# takes 4 passes (at 2^20, 16 passes were 12x slower than the flat decode)
GROUP_LEAF_BITS = 22


def collision_capacity(D: int) -> int:
    """Entries of the collision arrays for a depth-D tree: ~2^(D+1) built
    nodes and up to ``MAX_ADD_LEVELS`` grown nodes per leaf, each inserting
    at most two entries.  (The reference sizes them to numNodes,
    ``HashedKdtree.cpp:43-45``, which 2^(D+1) − 1 nodes hashed into 2^D
    slots can overflow.)"""
    n = 1 << D
    return 2 * (2 * n + MAX_ADD_LEVELS * n) + 8


@dataclasses.dataclass
class HashedKdTree:
    """The hashed tree's tables; the fields are the JAX package's
    ``HashedKdTree``'s (``interop.hashed_from_numpy`` carries one across)."""

    dims: tuple[int, int, int]      # (X, Y, Z)
    orig_depth: int
    tree_depth: int                 # may exceed orig_depth after growth
    hash_mask: int
    distance_map: np.ndarray        # uint8 (tree_depth + 1,)
    tree_data: np.ndarray           # uint8 codes (2^orig_depth,), 3 = collision
    tree_structure: np.ndarray      # uint8 (2^orig_depth,)
    coll_keys: np.ndarray           # int64 mcodes, sorted
    coll_vals: np.ndarray           # int32 indices into the collision arrays
    coll_data: np.ndarray           # uint8 codes
    coll_structure: np.ndarray      # uint8
    tolerance: int = DEFAULT_TOLERANCE

    @property
    def num_collisions(self) -> int:
        return len(self.coll_keys)

    def lookup(self, mcode: int) -> tuple[int, int]:
        """(data code, structure) for one node, resolving collisions."""
        key = mcode & self.hash_mask
        code = int(self.tree_data[key])
        if code == 3:
            i = np.searchsorted(self.coll_keys, mcode)
            cidx = int(self.coll_vals[i])
            return int(self.coll_data[cidx]), int(self.coll_structure[cidx])
        return code, int(self.tree_structure[key])


def _deterministic_child(mcode: int) -> int:
    """The grown child of a node, 1 (left) or 2 (right), in place of the
    reference's shuffled pick (``HashedKdtree.cpp:473``)."""
    h = (mcode * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    return 1 + ((h >> 61) & 1)


def _pyramid(volume: np.ndarray):
    """(dims, D, [(mid, uniform) of depth d's nodes for d = 0 .. D]): the
    midrange and uniformity of every node (equal to the reference's per-box scans,
    ``HashedKdtree.cpp:103-124``)."""
    volume = np.asarray(volume, dtype=np.uint8)
    Z, Y, X = volume.shape
    schedule = split_schedule(X, Y, Z)
    D = len(schedule)
    leaves = volume_to_leaves(volume, schedule)
    levels = [None] * (D + 1)
    levels[D] = (leaves, np.ones_like(leaves, dtype=bool))
    lmin = lmax = leaves
    for d in range(D - 1, -1, -1):
        lmin = np.minimum(lmin[0::2], lmin[1::2])
        lmax = np.maximum(lmax[0::2], lmax[1::2])
        levels[d] = (((lmin.astype(np.uint16) + lmax) // 2).astype(np.uint8), lmin == lmax)
    return (X, Y, Z), D, levels


class _Builder:
    """The two build passes in Python, node by node in the reference's
    order."""

    def __init__(self, volume: np.ndarray, tolerance: int):
        self.dims, self.D, levels = _pyramid(volume)
        self.mid = [m for m, _ in levels]
        self.uniform = [u for _, u in levels]
        self.tree_depth = self.D
        self.tolerance = tolerance

        n = 1 << self.D
        self.hash_mask = n - 1
        self.temp = np.zeros(n, dtype=np.uint8)
        self.visited = np.zeros(n, dtype=np.int64)
        self.tree_data = np.zeros(n, dtype=np.uint8)
        self.tree_structure = np.zeros(n, dtype=np.uint8)
        ncoll = collision_capacity(self.D)
        self.temp_coll = np.zeros(ncoll, dtype=np.uint8)
        self.coll_data = np.zeros(ncoll, dtype=np.uint8)
        self.coll_structure = np.zeros(ncoll, dtype=np.uint8)
        self.collisions: dict[int, int] = {}
        self.last_coll_idx = 0
        self.sums = np.zeros(self.D + 1 + MAX_ADD_LEVELS, dtype=np.float64)
        self.counts = np.zeros(self.D + 1 + MAX_ADD_LEVELS, dtype=np.float64)
        self.distance_map = np.zeros(self.D + 1, dtype=np.uint8)

    # -- collision machinery (HashedKdtree.cpp:126-166,413-443) ------------- #

    def _resolve(self, mcode: int) -> tuple[bool, int]:
        """Visit a node; returns (is_collision, key-or-collision-idx)."""
        key = mcode & self.hash_mask
        is_coll = self.tree_data[key] == 3
        if not is_coll:
            if self.visited[key] == 0:
                self.visited[key] = mcode
            elif self.visited[key] != mcode:
                prev = int(self.visited[key])
                if prev not in self.collisions:
                    pidx = self.last_coll_idx
                    self.last_coll_idx += 1
                    self.collisions[prev] = pidx
                    self.temp_coll[pidx] = self.temp[key]
                    self.coll_structure[pidx] = self.tree_structure[key]
                    self.coll_data[pidx] = self.tree_data[key]
                if mcode not in self.collisions:
                    self.collisions[mcode] = self.last_coll_idx
                    self.last_coll_idx += 1
                self.tree_data[key] = 3
                is_coll = True
        if is_coll:
            if mcode not in self.collisions:
                self.collisions[mcode] = self.last_coll_idx
                self.last_coll_idx += 1
            return True, self.collisions[mcode]
        return False, int(key)

    # -- encodeNode (HashedKdtree.cpp:338-404) ------------------------------ #

    def _encode(self, depth, parent, truth, use_map, coll_idx=-1):
        pe = float(parent)
        t = float(truth)
        pd = abs(pe - t)
        md = float(self.distance_map[depth]) if use_map else \
            (self.sums[depth] + pd) / (self.counts[depth] + 1.0)
        none_err = pd
        add_est = min(255.0, pe + md)
        add_err = abs(add_est - t)
        sub_est = max(0.0, pe - md)
        sub_err = abs(sub_est - t)
        min_err = min(sub_err, min(none_err, add_err))
        if min_err == none_err:
            code, est = 0, pe
        elif min_err == add_err:
            code, est = 1, add_est
            if not use_map:
                self.sums[depth] += add_err   # the residual, not the parent distance
                self.counts[depth] += 1
        else:
            code, est = 2, sub_est
            if not use_map:
                self.sums[depth] += sub_err
                self.counts[depth] += 1
        if use_map and coll_idx > -1:
            self.coll_data[coll_idx] = code
        return code, int(est)

    def _encode_store(self, depth, parent, truth, use_map, is_coll, key):
        code, est = self._encode(depth, parent, truth, use_map,
                                 coll_idx=key if is_coll else -1)
        if use_map and not is_coll:
            self.tree_data[key] = code
        return est

    # -- pass 1 (buildRecursive, :96-214) ----------------------------------- #

    def pass1(self):
        # explicit DFS, left first (the visit order decides slot ownership)
        stack = [(1, 0, 0, 0)]  # mcode, depth, level-local index, parent estimate
        while stack:
            mcode, depth, li, parent_est = stack.pop()
            midrange = int(self.mid[depth][li])
            is_leaf = bool(self.uniform[depth][li])
            is_coll, key = self._resolve(mcode)
            if is_coll:
                self.temp_coll[key] = midrange
            else:
                self.temp[key] = midrange
            est = self._encode_store(depth, parent_est, midrange, False, is_coll, key)
            if depth < self.D:
                if not is_leaf:
                    if is_coll:
                        self.coll_structure[key] = 3
                    else:
                        self.tree_structure[key] = 3
                # push right then left so that left is processed first
                stack.append((2 * mcode + 1, depth + 1, 2 * li + 1, est))
                stack.append((2 * mcode + 0, depth + 1, 2 * li + 0, est))

    # -- pass 2 (compressTreeRecursive, :406-507) --------------------------- #

    def pass2(self):
        # ``visited`` is NOT reset: the reference reuses pass 1's array
        # (:413-435), so a grown node whose slot belongs to a pass-1 owner
        # goes through the eviction machinery
        add_dist = ADD_LEVEL_START
        add_left = MAX_ADD_LEVELS

        # the left subtree fully before the right (growth can extend
        # tree_depth in the middle of the pass)
        def rec(mcode, depth, parent_est, true_override):
            nonlocal add_dist, add_left
            is_coll, key = self._resolve(mcode)
            if is_coll:
                children = int(self.coll_structure[key])
                truth = true_override if true_override != -1 else int(self.temp_coll[key])
            else:
                children = int(self.tree_structure[key])
                truth = true_override if true_override != -1 else int(self.temp[key])
            est = self._encode_store(depth, parent_est, truth, True, is_coll, key)
            if children == 0:
                leaf_err = abs(est - truth)
                if leaf_err > 0 and depth < self.D:
                    children = 3
                    if is_coll:
                        self.coll_structure[key] = 3
                    else:
                        self.tree_structure[key] = 3
                elif leaf_err > self.tolerance and (depth < self.tree_depth or add_left > 0):
                    children = _deterministic_child(mcode)
                    if is_coll:
                        self.coll_structure[key] = children
                    else:
                        self.tree_structure[key] = children
                    true_override = truth
                    if depth == self.tree_depth and add_left > 0:
                        self.tree_depth += 1
                        self.distance_map = np.append(self.distance_map, np.uint8(add_dist))
                        add_dist //= 2
                        add_left -= 1
                else:
                    return
            if children in (3, 1):
                rec(2 * mcode, depth + 1, est, true_override)
            if children in (3, 2):
                rec(2 * mcode + 1, depth + 1, est, true_override)

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, self.tree_depth + MAX_ADD_LEVELS + 100))
        try:
            rec(1, 0, 0, -1)
        finally:
            sys.setrecursionlimit(old)

    def finish(self) -> HashedKdTree:
        keys = np.array(sorted(self.collisions.keys()), dtype=np.int64)
        vals = np.array([self.collisions[k] for k in keys], dtype=np.int32)
        return HashedKdTree(
            dims=self.dims, orig_depth=self.D, tree_depth=self.tree_depth,
            hash_mask=self.hash_mask, distance_map=self.distance_map,
            tree_data=self.tree_data, tree_structure=self.tree_structure,
            coll_keys=keys, coll_vals=vals,
            coll_data=self.coll_data[:self.last_coll_idx].copy(),
            coll_structure=self.coll_structure[:self.last_coll_idx].copy(),
            tolerance=self.tolerance)


def build(volume: np.ndarray, tolerance: int = DEFAULT_TOLERANCE,
          use_native: bool | None = None) -> HashedKdTree:
    """Compress a (Z, Y, X) uint8 volume.  ``use_native=None`` builds in
    ``csrc/hashed_build.cu`` on a machine with a CUDA device (a failed build
    raises) and in the Python passes elsewhere; ``True`` / ``False`` force
    either.  Both give the same tree, array for array."""
    if use_native is None:
        use_native = torch.cuda.is_available()
    if use_native:
        return _build_native(volume, tolerance)
    b = _Builder(volume, tolerance)
    b.pass1()
    # distanceMap[d] = (byte)(sums/counts), truncated (:59-61)
    with np.errstate(invalid="ignore", divide="ignore"):
        dm = np.where(b.counts[:b.D + 1] > 0,
                      b.sums[:b.D + 1] / np.maximum(b.counts[:b.D + 1], 1), 0)
    b.distance_map = dm.astype(np.uint8)
    b.pass2()
    return b.finish()


@functools.cache
def _native_helper():
    from ..ops.cuda import _build

    built = _build.load("hashed_build")
    fn = built.lib.hashed_build_native
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   *[ctypes.c_void_p] * 7]
    fn.restype = ctypes.c_int64
    return fn, built


def _build_native(volume: np.ndarray, tolerance: int) -> HashedKdTree:
    """The build passes in ``csrc/hashed_build.cu``, on the pyramid laid out
    flat (level d at offset 2^d − 1)."""
    dims, D, levels = _pyramid(volume)
    mid_flat = np.concatenate([m for m, _ in levels])
    uni_flat = np.concatenate([u for _, u in levels]).astype(np.uint8)
    n = 1 << D
    ncoll = collision_capacity(D)
    tree_data = np.zeros(n, dtype=np.uint8)
    tree_structure = np.zeros(n, dtype=np.uint8)
    coll_data = np.zeros(ncoll, dtype=np.uint8)
    coll_structure = np.zeros(ncoll, dtype=np.uint8)
    key_by_idx = np.zeros(ncoll, dtype=np.int64)
    dm = np.zeros(64, dtype=np.uint8)
    tree_depth = np.zeros(1, dtype=np.int32)
    fn, _ = _native_helper()
    n_coll = int(fn(mid_flat.ctypes.data, uni_flat.ctypes.data, D, int(tolerance),
                    tree_data.ctypes.data, tree_structure.ctypes.data, coll_data.ctypes.data,
                    coll_structure.ctypes.data, key_by_idx.ctypes.data, dm.ctypes.data,
                    tree_depth.ctypes.data))
    depth = int(tree_depth[0])
    order = np.argsort(key_by_idx[:n_coll], kind="stable")
    return HashedKdTree(
        dims=dims, orig_depth=D, tree_depth=depth, hash_mask=n - 1,
        distance_map=dm[:depth + 1].copy(), tree_data=tree_data, tree_structure=tree_structure,
        coll_keys=key_by_idx[:n_coll][order], coll_vals=order.astype(np.int32),
        coll_data=coll_data[:n_coll].copy(), coll_structure=coll_structure[:n_coll].copy(),
        tolerance=tolerance)


def level_cut(tree: HashedKdTree, cut_depth: int | None = None) -> np.ndarray:
    """Structure-gated decode on the host (``levelCutRecursive``,
    ``:254-336``): a level sweep over the active Morton codes, each
    terminal node filling its leaf range.  A Python loop over the nodes."""
    X, Y, Z = tree.dims
    D = tree.orig_depth
    if cut_depth is None:
        cut_depth = tree.tree_depth
    leaves = np.zeros(1 << D, dtype=np.uint8)
    dm = tree.distance_map.astype(np.int32)

    active = [(1, 0)]  # (mcode, parent scalar)
    for depth in range(0, tree.tree_depth + 1):
        next_active = []
        for mcode, parent in active:
            code, children = tree.lookup(mcode)
            if code == 1:
                scalar = min(255, parent + int(dm[depth]))
            elif code == 2:
                scalar = max(0, parent - int(dm[depth]))
            else:
                scalar = parent
            if depth == cut_depth or children == 0:
                # a node at depth d covers the leaf range [path<<(D-d), ...)
                if depth <= D:
                    path = mcode - (1 << depth)
                    lo, hi = path << (D - depth), (path + 1) << (D - depth)
                else:
                    path = (mcode >> (depth - D)) - (1 << D)
                    lo, hi = path, path + 1
                leaves[lo:hi] = scalar
                continue
            if children in (3, 1):
                next_active.append((2 * mcode, scalar))
            if children in (3, 2):
                next_active.append((2 * mcode + 1, scalar))
        active = next_active
        if not active:
            break
    return leaves_to_volume(leaves, tree.dims, split_schedule(X, Y, Z))


def save(tree: HashedKdTree, path: str) -> None:
    """The reference file format (``HashedKdtree.cpp:509-554``)."""
    X, Y, Z = tree.dims
    nc = tree.num_collisions
    with open(path, "wb") as f:
        f.write(struct.pack("<3q", 0, 0, 0))
        f.write(struct.pack("<3q", X, Y, Z))
        f.write(struct.pack("<i", tree.tree_depth))
        f.write(struct.pack("<3q", X, Y, Z))
        f.write(struct.pack("<q", tree.hash_mask))
        f.write(struct.pack("<q", nc))
        f.write(tree.distance_map.tobytes())
        f.write(pack2_np(tree.tree_data).tobytes())
        f.write(pack2_np(tree.tree_structure).tobytes())
        f.write(pack2_np(tree.coll_data[:nc]).tobytes())
        f.write(pack2_np(tree.coll_structure[:nc]).tobytes())
        f.write(tree.coll_keys.astype("<i8").tobytes())
        f.write(tree.coll_vals.astype("<i4").tobytes())


def open_tree(path: str) -> HashedKdTree:
    """Read a tree that :func:`save` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    off = 48
    (tree_depth,) = struct.unpack_from("<i", data, off); off += 4
    X, Y, Z = struct.unpack_from("<3q", data, off); off += 24
    (hash_mask,) = struct.unpack_from("<q", data, off); off += 8
    (nc,) = struct.unpack_from("<q", data, off); off += 8
    dm = np.frombuffer(data, np.uint8, tree_depth + 1, off).copy()
    off += tree_depth + 1
    n = hash_mask + 1
    nb = (n + 3) // 4
    td = unpack2_np(np.frombuffer(data, np.uint8, nb, off), n); off += nb
    ts = unpack2_np(np.frombuffer(data, np.uint8, nb, off), n); off += nb
    cb = (nc + 3) // 4
    cd = unpack2_np(np.frombuffer(data, np.uint8, cb, off), nc); off += cb
    cs = unpack2_np(np.frombuffer(data, np.uint8, cb, off), nc); off += cb
    keys = np.frombuffer(data, "<i8", nc, off).copy(); off += 8 * nc
    vals = np.frombuffer(data, "<i4", nc, off).copy()
    D = int(np.log2(n))
    order = np.argsort(keys)
    return HashedKdTree(dims=(X, Y, Z), orig_depth=D, tree_depth=tree_depth,
                        hash_mask=hash_mask, distance_map=dm, tree_data=td,
                        tree_structure=ts, coll_keys=keys[order],
                        coll_vals=vals[order], coll_data=cd, coll_structure=cs)


# --------------------------------------------------------------------------- #
# the decode on the tree's device
# --------------------------------------------------------------------------- #

class DeviceHashedKdTree(NamedTuple):
    """The hashed tree's tables as tensors on one device."""

    node_bits: torch.Tensor     # uint8 (2^orig_depth,): data | structure << 2
    coll_keys: torch.Tensor     # int64 (num_collisions,), sorted
    coll_bits: torch.Tensor     # uint8 (num_collisions,), in key order
    depth_starts: tuple         # key index of the first key >= 2^d, d = 0 .. tree_depth + 1


def to_device_hashed(tree: HashedKdTree,
                     device: torch.device | str = "cuda") -> DeviceHashedKdTree:
    """Put a host tree's tables on ``device`` for :func:`level_cut_device_hashed`."""
    node_bits = (tree.tree_data & 3) | ((tree.tree_structure & 3) << 2)
    coll_bits = (tree.coll_data[tree.coll_vals] & 3) | ((tree.coll_structure[tree.coll_vals] & 3)
                                                        << 2)
    keys = np.asarray(tree.coll_keys, dtype=np.int64)
    starts = np.searchsorted(keys, [1 << d for d in range(tree.tree_depth + 2)])
    return DeviceHashedKdTree(
        node_bits=torch.from_numpy(node_bits.astype(np.uint8)).to(device),
        coll_keys=torch.from_numpy(keys.copy()).to(device),
        coll_bits=torch.from_numpy(coll_bits.astype(np.uint8)).to(device),
        depth_starts=tuple(int(s) for s in starts))


class _Decode(NamedTuple):
    dt: DeviceHashedKdTree
    dm: tuple          # the distance map as ints
    mask: int
    cut: int
    D: int
    tree_depth: int


def _lookup(p: _Decode, mcodes: torch.Tensor, d: int):
    """(code, children) as int32 of depth-d nodes, collisions resolved."""
    bits = p.dt.node_bits[mcodes & p.mask]
    lo, hi = p.dt.depth_starts[d], p.dt.depth_starts[d + 1]
    if hi > lo:
        keys = p.dt.coll_keys[lo:hi]
        pos = torch.searchsorted(keys, mcodes).clamp_(max=hi - lo - 1)
        bits = torch.where((bits & 3) == 3, p.dt.coll_bits[lo:hi][pos], bits)
    bits = bits.to(torch.int32)
    return bits & 3, bits >> 2


def _apply(p: _Decode, scalars, code, d: int):
    delta = p.dm[d]
    return torch.where(code == 1, torch.clamp(scalars + delta, max=255),
                       torch.where(code == 2, torch.clamp(scalars - delta, min=0), scalars))


def _mcodes(d: int, d0: int, base: int, n0: int, device) -> torch.Tensor:
    """Morton codes of the depth-d descendants of the n0 consecutive depth-d0
    nodes from index ``base``."""
    k = d - d0
    return torch.arange(n0 << k, dtype=torch.int64, device=device) + ((1 << d) + (base << k))


def _descend(p: _Decode, d0: int, d1: int, state, base: int):
    """Sweep depths d0 .. d1 − 1 (all above min(cut, D)) from the states of
    the depth-d0 nodes ``base ..``; returns the states of their depth-d1
    descendants: (scalars, active, frozen, filled)."""
    scalars, active, frozen, filled = state
    n0 = scalars.shape[0]
    for d in range(d0, d1):
        code, children = _lookup(p, _mcodes(d, d0, base, n0, scalars.device), d)
        s = _apply(p, scalars, code, d)
        terminal = active & ((children == 0) | (d == p.cut))
        frozen = torch.where(terminal, s, frozen)
        filled = filled | terminal
        go = active & ~terminal
        left = go & ((children == 3) | (children == 1))
        right = go & ((children == 3) | (children == 2))
        active = torch.stack([left, right], 1).reshape(-1)
        scalars = s.repeat_interleave(2)
        frozen = frozen.repeat_interleave(2)
        filled = filled.repeat_interleave(2)
    return scalars, active, frozen, filled


def _finish(p: _Decode, d0: int, state, base: int):
    """The last level, min(cut, D), of the nodes whose states are given (at
    that depth, from ``base``), and below D the grown unary chains.
    Returns (int32 values of those nodes, leaves each value covers)."""
    scalars, active, frozen, filled = state
    stop = min(p.cut, p.D)
    mcodes = _mcodes(stop, d0, base, scalars.shape[0], scalars.device)
    code, children = _lookup(p, mcodes, stop)
    s = _apply(p, scalars, code, stop)
    terminal = active & ((children == 0) | (stop == p.cut))
    frozen = torch.where(terminal, s, frozen)
    filled = filled | terminal
    if stop < p.D:
        return torch.where(filled, frozen, scalars), 1 << (p.D - stop)
    s = torch.where(filled, frozen, s)
    act = active & ~terminal
    cur_m, cur_children = mcodes, children
    for d in range(p.D + 1, min(p.cut, p.tree_depth) + 1):
        cur_m = (cur_m << 1) | (cur_children == 2).to(torch.int64)
        code, children = _lookup(p, cur_m, d)
        s = torch.where(act, _apply(p, s, code, d), s)
        terminal = act & ((children == 0) | (d == p.cut))
        act = act & ~terminal
        cur_children = children
    return s, 1


def _root_state(device):
    z = torch.zeros(1, dtype=torch.int32, device=device)
    return z, torch.ones(1, dtype=torch.bool, device=device), z.clone(), \
        torch.zeros(1, dtype=torch.bool, device=device)


def level_cut_device_hashed(tree: HashedKdTree, dev: DeviceHashedKdTree,
                            cut_depth: int | None = None,
                            chunk_bits: int | None = None) -> torch.Tensor:
    """Decode a level cut on the tables' device; returns (Z, Y, X) uint8,
    equal to :func:`level_cut` bit for bit.

    Trees of depth ``>= device.CHUNKED_DECODE_MIN_DEPTH`` decode per depth-K
    subtree of 2^``CHUNK_LEAF_BITS`` leaves; ``chunk_bits`` forces a chunk of
    2^chunk_bits leaves at any depth (tests).  The flat decode puts its
    leaves in volume order by one reshape to (2,)*D, so it takes trees up
    to D = 25 (CUDA copies take up to 25 dims); the chunked one any."""
    X, Y, Z = tree.dims
    D = tree.orig_depth
    if cut_depth is None:
        cut_depth = tree.tree_depth
    cut = int(cut_depth)
    p = _Decode(dev, tuple(int(x) for x in tree.distance_map), tree.hash_mask, cut, D,
                tree.tree_depth)
    device = dev.node_bits.device
    schedule = split_schedule(X, Y, Z)
    stop = min(cut, D)
    bits = chunk_bits if chunk_bits is not None else (
        _dev.CHUNK_LEAF_BITS if D >= _dev.CHUNKED_DECODE_MIN_DEPTH else None)
    if bits is None or D - 1 <= bits:
        state = _descend(p, 0, stop, _root_state(device), 0)
        values, rep = _finish(p, stop, state, 0)
        return _dev._leaves_to_volume(values.repeat_interleave(rep), tree.dims, schedule)

    K = D - bits
    L = 1 << bits
    if stop < K:
        # the cut lies above the chunks: each chunk is one value's leaves
        values, rep = _finish(p, stop, _descend(p, 0, stop, _root_state(device), 0), 0)

        def group(c0, g):
            idx = torch.arange(c0 * L, (c0 + g) * L, dtype=torch.int64, device=device)
            return values[idx >> (D - stop)]
    else:
        top = _descend(p, 0, K, _root_state(device), 0)

        def group(c0, g):
            state = _descend(p, K, stop, tuple(t[c0:c0 + g] for t in top), c0)
            vals, rep = _finish(p, stop, state, c0 << (stop - K))
            return vals.repeat_interleave(rep) if rep > 1 else vals
    return _dev._place_chunks(tree.dims, schedule, K, group, device, GROUP_LEAF_BITS)
