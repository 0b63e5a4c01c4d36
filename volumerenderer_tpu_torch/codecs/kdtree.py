"""Progressive kd-tree codec, built on the host with numpy.

Counterpart of ``volumerenderer_tpu/codecs/kdtree.py`` (the reference's
``VolumeKdTree_recover.cpp``), with the same level-structured layout and the
same two documented deviations from the literal C++ (a per-evaluation error
reset, and a final re-encode at the chosen Δ).  Passes:

* BUILD: a midrange pyramid over the full binary kd-tree whose split
  dimension cycles x/y/z (:func:`split_schedule`);
* COMPRESS: per depth, Δ is seeded by a level-order running mean
  (:func:`seed_level`) and refined by gradient descent on the mean squared
  per-node error (:func:`gd_fit_level`); each node gets a 2-bit code
  {0: keep parent, 1: +Δ, 2: −Δ} (:func:`encode_level`);
* PRUNE: a subtree of zero codes whose leaves are within tolerance collapses
  to code 3 (:func:`_prune`);
* GROW: unary chains on the fixed Δ ladder 64..1 under leaves whose error
  exceeds the tolerance, trailing zero runs pruned to 3 (:func:`_grow_chains`).

:func:`level_cut` decodes on the host; ``codecs/device.py`` decodes on the
tree's device.  Every pass is numpy array code except the Δ seeding, a
running mean carried node by node: on a machine with a CUDA device it runs in
the compiled host helper ``csrc/kdtree_seed.cu`` (the JAX package's
``native/kdtree_native.cpp::seed_level_f64``), elsewhere in a Python loop.

Checkpoints (:func:`save`, :func:`open_tree`, :func:`open_tree_full`) are the
reference's file format (``VolumeKdTree_recover.cpp:521-552``), byte for byte
the JAX package's: a file written by either package opens in the other.
:func:`preorder_to_levels` rebuilds the level layout from the stored preorder
stream, natively (``csrc/kdtree_native.cu``) on a machine with a CUDA device
and in a Python walk elsewhere; ``use_native`` forces either, and a native
walk whose library fails to build raises.  The JAX package gives way to the
Python walk on any ``OSError`` of its native library
(``volumerenderer_tpu/codecs/kdtree.py:617-636``); here nothing falls back.

Power-of-two dimensions only, as in the JAX package; any dimensions build
through ``codecs/reference_impl.py``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct

import numpy as np
import torch

from ..utils.bitarray import pack2_np, unpack2_np

__all__ = ["KdTree", "build", "level_cut", "split_schedule", "volume_to_leaves",
           "leaves_to_volume", "encode_level", "seed_level", "gd_fit_level", "fit_distance",
           "measure_max_error", "measure_mean_error", "query_error", "to_preorder", "save",
           "open_tree", "open_tree_full", "preorder_to_levels", "ADD_LEVEL_DISTANCES",
           "MAX_ADD_LEVELS", "NO_NODE"]

MAX_ADD_LEVELS = 7                                # VolumeKdTree_recover.cpp:22
ADD_LEVEL_DISTANCES = (64, 32, 16, 8, 4, 2, 1)    # VolumeKdTree_recover.cpp:23
GAMMA = 1.25                                      # step size multiplier (:209)
H = 1.0                                           # central difference interval (:210)
MAX_ABS_STEP = 4.0                                # (:211)
NO_NODE = 255  # chain padding marker


def split_schedule(X: int, Y: int, Z: int) -> list[int]:
    """Per-depth split dimension (0=x, 1=y, 2=z): the cycle-and-skip rule of
    ``buildRecursive`` (``VolumeKdTree_recover.cpp:151-159``).  Requires
    power-of-two dims, so every node of a depth has the same extent."""
    for n, d in ((X, "X"), (Y, "Y"), (Z, "Z")):
        if n & (n - 1) or n <= 0:
            raise ValueError(
                f"vectorized kd-tree requires power-of-two dims, got {d}={n}; "
                "compress per power-of-two brick instead")
    ext = [X, Y, Z]
    depth_total = int(np.log2(X)) + int(np.log2(Y)) + int(np.log2(Z))
    schedule = []
    for depth in range(depth_total):
        sd = depth % 3
        i = 0
        num_cells = ext[0] * ext[1] * ext[2]
        while num_cells > 1 and ext[sd] == 1:
            i += 1
            sd = (depth + i) % 3
        schedule.append(sd)
        ext[sd] //= 2
    return schedule


def _leaf_axes_perm(X: int, Y: int, Z: int, schedule: list[int]):
    """Axis permutation taking the (Z, Y, X) volume reshaped into per-bit axes
    (z bits MSB first, then y bits, then x bits) to breadth-first leaf order:
    leaf n's bits go MSB-first to the split dims in schedule order."""
    nx, ny, nz = int(np.log2(X)), int(np.log2(Y)), int(np.log2(Z))
    offsets = {2: 0, 1: nz, 0: nz + ny}
    counters = {0: 0, 1: 0, 2: 0}
    perm = []
    for sd in schedule:
        perm.append(offsets[sd] + counters[sd])
        counters[sd] += 1
    return perm, (nz, ny, nx)


def volume_to_leaves(volume: np.ndarray, schedule: list[int]) -> np.ndarray:
    """(Z, Y, X) volume -> flat array in breadth-first leaf order."""
    Z, Y, X = volume.shape
    perm, (nz, ny, nx) = _leaf_axes_perm(X, Y, Z, schedule)
    v = volume.reshape((2,) * (nz + ny + nx))
    return np.ascontiguousarray(v.transpose(perm)).reshape(-1)


def leaves_to_volume(leaves: np.ndarray, dims: tuple[int, int, int],
                     schedule: list[int]) -> np.ndarray:
    """Inverse of :func:`volume_to_leaves`; dims = (X, Y, Z)."""
    X, Y, Z = dims
    perm, (nz, ny, nx) = _leaf_axes_perm(X, Y, Z, schedule)
    inv = np.argsort(perm)
    v = leaves.reshape((2,) * (nz + ny + nx)).transpose(inv)
    return np.ascontiguousarray(v).reshape(Z, Y, X)


def encode_level(truth: np.ndarray, parent: np.ndarray, distance: int):
    """``encodeNode`` (``VolumeKdTree_recover.cpp:457-502``) over one level,
    in exact integers; tie order none > add > sub.

    Returns (codes uint8, recon int32, min_err int64)."""
    t = truth.astype(np.int64)
    p = parent.astype(np.int64)
    none_err = np.abs(p - t)
    add_est = np.minimum(255, p + distance)
    add_err = np.abs(add_est - t)
    sub_est = np.maximum(0, p - distance)
    sub_err = np.abs(sub_est - t)
    min_err = np.minimum(sub_err, np.minimum(none_err, add_err))
    codes = np.where(none_err == min_err, 0,
                     np.where(add_err == min_err, 1, 2)).astype(np.uint8)
    recon = np.where(codes == 0, p, np.where(codes == 1, add_est, sub_est)).astype(np.int32)
    return codes, recon, min_err


def seed_level(truth: np.ndarray, parent: np.ndarray, shift: int = 0) -> float:
    """Level-order running-mean Δ seeding (``encodeNodeEstimate`` sweep,
    ``VolumeKdTree_recover.cpp:254-267,415-455``): round(sum / count), or 0.
    Node i's parent estimate is ``parent[i >> shift]``: shift 1 seeds a
    level from its parent level's recon.

    On a machine with a CUDA device the sweep runs in the compiled host
    helper (``csrc/kdtree_seed.cu``, built with ``nvcc`` at first use; a
    failed build raises), elsewhere in :func:`_seed_level_py`.  Both give the
    same (sum, count) bit for bit."""
    if torch.cuda.is_available():
        s, c = _seed_level_native(truth, parent, shift)
    else:
        s, c = _seed_level_py(truth, np.repeat(parent, 1 << shift)[:len(truth)])
    if c > 0:
        return float(np.floor(s / c + 0.5))  # C++ round(): half away from zero
    return 0.0


def _seed_level_py(truth: np.ndarray, parent: np.ndarray):
    s = 0.0
    c = 0.0
    t = truth.astype(np.float64)
    p = parent.astype(np.float64)
    for i in range(t.shape[0]):
        pe = p[i]
        pd = abs(pe - t[i])
        md = (s + pd) / (c + 1.0)
        none_err = pd
        add_err = abs(min(255.0, pe + md) - t[i])
        sub_err = abs(max(0.0, pe - md) - t[i])
        min_err = min(sub_err, min(none_err, add_err))
        if min_err == none_err:
            continue
        # add or sub chosen: both update the running stats alike
        s += pd
        c += 1.0
    return s, c


@functools.cache
def _seed_helper():
    from ..ops.cuda import _build

    built = _build.load("kdtree_seed")
    fns = {}
    for name, ptype in (("u8", np.uint8), ("i32", np.int32)):
        fn = getattr(built.lib, f"kdtree_seed_level_{name}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = None
        fns[np.dtype(ptype)] = fn
    return fns, built


def _seed_level_native(truth: np.ndarray, parent: np.ndarray, shift: int = 0):
    """:func:`_seed_level_py` in the compiled helper: (sum, count).  It reads
    the truth bytes and the parent estimates (bytes, else int32) in place;
    node i's estimate is ``parent[i >> shift]``."""
    t = np.ascontiguousarray(truth, dtype=np.uint8).ravel()
    p = np.ascontiguousarray(parent).ravel()
    if p.dtype != np.uint8:
        p = np.ascontiguousarray(p, dtype=np.int32)
    n = t.shape[0]
    if n and p.shape[0] <= (n - 1) >> shift:
        raise ValueError(f"{p.shape[0]} parent estimates for {n} nodes at shift {shift}")
    out = np.zeros(2, dtype=np.float64)
    fns, _ = _seed_helper()
    fns[p.dtype](t.ctypes.data, p.ctypes.data, n, shift, out.ctypes.data)
    return float(out[0]), float(out[1])


def _mean_sq_err(truth: np.ndarray, parent: np.ndarray, distance: int) -> float:
    _, _, min_err = encode_level(truth, parent, distance)
    # exact: integer errors <= 255, squared sums < 2^53 for any realistic level
    return float(np.sum(min_err * min_err, dtype=np.int64)) / truth.shape[0]


def gd_fit_level(truth: np.ndarray, parent: np.ndarray, max_epochs: int,
                 seed_distance: float):
    """Gradient descent on Δ for one level (``VolumeKdTree_recover.cpp:271-369``,
    :func:`fit_distance`) on the host.

    Returns (distance, codes, recon), the codes and recon from a final encode
    at the chosen Δ."""
    distance = fit_distance(lambda d: _mean_sq_err(truth, parent, d), max_epochs, seed_distance)
    codes, recon, _ = encode_level(truth, parent, distance)
    return distance, codes, recon


def fit_distance(mean_sq_err, max_epochs: int, seed_distance: float) -> int:
    """The gradient descent on Δ, given the level's mean squared error as a
    function of an integer Δ: revert on an error increase with step
    halving, stop on a re-quantized repeat, central difference at Δ±1,
    step = clamp(−γ·DF, ±4).  Shared by the host build and
    ``codecs/device_build.py``, whose errors are evaluated on the device."""
    epoch = 0
    current_distance = seed_distance
    previous_distance = 0.0
    previous_step = 255.0
    previous_error = 65025.0
    current_error = current_df = current_step = 0.0

    while epoch < max_epochs and abs(previous_step) >= 0.5:
        if epoch != 0:
            previous_distance = current_distance
            previous_error = current_error
            previous_df = current_df
            previous_step = current_step
            current_distance = float(np.floor(
                min(255.0, max(0.0, previous_distance + previous_step)) + 0.5))
            if current_distance == previous_distance:
                break

        current_error = mean_sq_err(int(current_distance))

        if current_error < 1.0:
            break

        if epoch != 0 and current_error > previous_error:
            current_error = previous_error
            current_distance = previous_distance
            current_df = previous_df
            current_step = previous_step / 2.0
            epoch += 1
            continue

        lo = int(max(0.0, current_distance - H))
        hi = int(min(255.0, current_distance + H))
        err_lo = mean_sq_err(lo)
        err_hi = mean_sq_err(hi)
        current_df = (err_hi - err_lo) / (2.0 * H)
        current_step = max(-MAX_ABS_STEP, min(MAX_ABS_STEP, -GAMMA * current_df))
        epoch += 1

    return int(current_distance)


@dataclasses.dataclass
class KdTree:
    """Compressed tree in level-structured layout.

    ``level_codes[d]`` holds the 2-bit codes of all 2^d nodes at depth d
    (breadth-first), after pruning.  ``chain_codes`` holds the grown unary
    branches under each leaf, (num_leaves, MAX_ADD_LEVELS) uint8 with
    ``NO_NODE`` (255) marking "no node".  The fields are the JAX package's
    ``KdTree``'s (``interop.kdtree_from_numpy`` carries one across)."""

    dims: tuple[int, int, int]               # (X, Y, Z)
    orig_depth: int
    max_depth: int
    distance_map: np.ndarray                 # uint8 (max_depth + 1,)
    level_codes: list[np.ndarray]
    chain_codes: np.ndarray | None
    schedule: list[int]
    tolerance: int = 6                       # defaults: VolumeKdtree_recover.h:110-112
    max_epochs: int = 5
    num_active_nodes: int = 0
    # build-time leaf recon / truth, kept for metrics and tests
    leaf_recon: np.ndarray | None = None
    leaf_truth: np.ndarray | None = None

    @property
    def num_leaves(self) -> int:
        return 1 << self.orig_depth


def build(volume: np.ndarray, tolerance: int = 6, max_epochs: int = 5,
          verbose: bool = False) -> KdTree:
    """Compress a (Z, Y, X) uint8 volume (``VolumeKdTree_recover.cpp:17-140``):
    pyramid, per-level Δ fit and encode, prune, chain growth."""
    volume = np.asarray(volume, dtype=np.uint8)
    Z, Y, X = volume.shape
    schedule = split_schedule(X, Y, Z)
    D = len(schedule)
    max_depth = D + MAX_ADD_LEVELS

    # midrange pyramid: leaf min = max = cell value; interior midrange =
    # (min + max) / 2 truncated (VolumeKdTree_recover.cpp:191-198)
    leaves = volume_to_leaves(volume, schedule)
    temp_levels: list[np.ndarray] = [None] * (D + 1)
    temp_levels[D] = leaves
    lmin = lmax = leaves
    for d in range(D - 1, -1, -1):
        lmin = np.minimum(lmin[0::2], lmin[1::2])
        lmax = np.maximum(lmax[0::2], lmax[1::2])
        temp_levels[d] = ((lmin.astype(np.uint16) + lmax) // 2).astype(np.uint8)

    distance_map = np.zeros(max_depth + 1, dtype=np.uint8)
    level_codes: list[np.ndarray] = []
    parent_recon = np.zeros(1, dtype=np.int32)  # the root's parent estimate is 0
    recon = None
    for d in range(D + 1):
        truth = temp_levels[d]
        parent = parent_recon if d == 0 else np.repeat(recon, 2)
        seed = seed_level(truth, parent)
        dist, codes, recon = gd_fit_level(truth, parent, max_epochs, seed)
        distance_map[d] = dist
        level_codes.append(codes)
        if verbose:
            print(f"depth {d}: Δ={dist} nodes={truth.shape[0]}")

    # the fixed Δ ladder of the chain levels (VolumeKdTree_recover.cpp:93-96)
    for i, dist in enumerate(ADD_LEVEL_DISTANCES):
        distance_map[D + 1 + i] = dist

    tree = KdTree(dims=(X, Y, Z), orig_depth=D, max_depth=max_depth,
                  distance_map=distance_map, level_codes=level_codes, chain_codes=None,
                  schedule=schedule, tolerance=tolerance, max_epochs=max_epochs,
                  leaf_recon=recon.copy(), leaf_truth=temp_levels[D])
    _prune(tree)
    _grow_chains(tree)
    tree.num_active_nodes = _count_active(tree)
    return tree


def _prune(tree: KdTree) -> None:
    """Bottom-up boolean pyramid (``pruneTreeRecursive``, ``:596-629``): a node
    is pruned iff its code is 0, both children were pruned, and (leaves only)
    |recon − truth| < tolerance."""
    D = tree.orig_depth
    err_ok = np.abs(tree.leaf_recon - tree.leaf_truth.astype(np.int32)) < tree.tolerance
    pruned = (tree.level_codes[D] == 0) & err_ok
    tree.level_codes[D] = np.where(pruned, 3, tree.level_codes[D]).astype(np.uint8)
    for d in range(D - 1, -1, -1):
        child_ok = pruned[0::2] & pruned[1::2]
        pruned = (tree.level_codes[d] == 0) & child_ok
        tree.level_codes[d] = np.where(pruned, 3, tree.level_codes[d]).astype(np.uint8)


def _grow_chains(tree: KdTree) -> None:
    """Per-leaf unary chains (``convertToPreorder``'s eval path, ``:655-697``):

    * a pruned leaf (code 3) gets no chain;
    * a leaf within tolerance gets a single terminal code-3 node;
    * a high-error leaf gets eval nodes (``encode_level`` on the fixed Δ
      ladder, updating recon) until |recon − truth| <= tolerance (then one
      terminal 3) or max_depth is reached;
    * a trailing run of code 0 at the end of a chain becomes 3 (``:662-670,
      684-689``).  The JAX package walks that run leaf by leaf; here it is
      one masked pass per chain column, with the same result.
    """
    D = tree.orig_depth
    n = tree.num_leaves
    max_chain = tree.max_depth - D  # nodes at depths D+1 .. max_depth
    chains = np.full((n, max_chain), NO_NODE, dtype=np.uint8)

    recon = tree.leaf_recon.astype(np.int32)
    truth = tree.leaf_truth.astype(np.int32)
    leaf_code = tree.level_codes[D]
    err = np.abs(recon - truth)
    active = (leaf_code != 3) & (err > tree.tolerance)   # chains still growing
    needs_terminal = (leaf_code != 3) & ~active          # 1-node chain: just 3
    chains[needs_terminal, 0] = 3
    # where each chain's trailing zero run starts (-1: none)
    zero_start = np.full(n, -1, dtype=np.int32)

    pos = 0
    while pos < max_chain and active.any():
        dist = int(tree.distance_map[D + 1 + pos])
        codes, new_recon, _ = encode_level(truth[active], recon[active], dist)
        recon[active] = new_recon
        chains[active, pos] = codes
        act_idx = np.nonzero(active)[0]
        zs = zero_start[act_idx]
        zero_start[act_idx] = np.where(codes == 0, np.where(zs == -1, pos, zs), -1)
        still = np.abs(recon[act_idx] - truth[act_idx]) > tree.tolerance
        if pos + 1 < max_chain:  # finished chains get a terminal 3 next
            chains[act_idx[~still], pos + 1] = 3
        active[:] = False
        active[act_idx[still]] = True
        pos += 1

    # trailing zero runs -> 3, from zero_start while the codes stay 0
    idx = np.nonzero(zero_start >= 0)[0]
    if idx.size:
        sub = chains[idx]
        zs = zero_start[idx]
        running = np.ones(idx.size, dtype=bool)
        for j in range(max_chain):
            at = running & (j >= zs)
            zero = at & (sub[:, j] == 0)
            sub[zero, j] = 3
            running &= ~(at & ~zero)
        chains[idx] = sub

    tree.chain_codes = chains
    tree.leaf_recon = recon


def _chain_lengths(tree: KdTree) -> np.ndarray:
    """Number of emitted preorder nodes in each leaf's chain."""
    return np.sum(tree.chain_codes != NO_NODE, axis=1).astype(np.int64)


def _count_active(tree: KdTree) -> int:
    """Total preorder nodes = numActiveNodes (``VolumeKdTree_recover.cpp:714``)."""
    return int(_subtree_sizes(tree)[0][0])


def _subtree_sizes(tree: KdTree) -> list[np.ndarray]:
    """sizes[d][i] = preorder entries emitted for the subtree rooted at node i
    of depth d (a code-3 node emits itself; a leaf adds its chain)."""
    D = tree.orig_depth
    sizes = [None] * (D + 1)
    sizes[D] = 1 + np.where(tree.level_codes[D] == 3, 0, _chain_lengths(tree))
    for d in range(D - 1, -1, -1):
        child_sum = sizes[d + 1][0::2] + sizes[d + 1][1::2]
        sizes[d] = np.where(tree.level_codes[d] == 3, 1, 1 + child_sum)
    return sizes


def level_cut(tree: KdTree, cut_depth: int | None = None) -> np.ndarray:
    """Decode a level cut on the host to a dense (Z, Y, X) uint8 volume.

    Level by level (``levelCut``, ``VolumeKdTree_recover.cpp:726-835``, as a
    clamped-Δ accumulation): scalar(root) = distanceMap[0] (``:743``, a
    reference quirk kept), child scalar = clamp(parent ± Δ[d]) by code,
    frozen below code-3 nodes and below the cut depth."""
    D = tree.orig_depth
    if cut_depth is None:
        cut_depth = tree.max_depth
    dm = tree.distance_map.astype(np.int32)

    scalars = np.array([dm[0]], dtype=np.int32)
    frozen = np.array([tree.level_codes[0][0] == 3])
    for d in range(1, D + 1):
        parent_s = np.repeat(scalars, 2)
        parent_f = np.repeat(frozen, 2)
        codes = tree.level_codes[d]
        if d > cut_depth:
            scalars = parent_s
            frozen = parent_f
            continue
        s = np.where(codes == 1, np.minimum(255, parent_s + dm[d]),
                     np.where(codes == 2, np.maximum(0, parent_s - dm[d]), parent_s))
        scalars = np.where(parent_f, parent_s, s)
        frozen = parent_f | (codes == 3)

    if cut_depth > D and tree.chain_codes is not None:
        chains = tree.chain_codes
        for step in range(min(chains.shape[1], cut_depth - D)):
            d = D + 1 + step
            codes = chains[:, step]
            live = ~frozen & (codes != NO_NODE)
            s = np.where(codes == 1, np.minimum(255, scalars + dm[d]),
                         np.where(codes == 2, np.maximum(0, scalars - dm[d]), scalars))
            scalars = np.where(live, s, scalars)
            frozen = frozen | (codes == 3) | (codes == NO_NODE)

    return leaves_to_volume(scalars.astype(np.uint8), tree.dims, tree.schedule)


def measure_max_error(decoded: np.ndarray, original: np.ndarray) -> int:
    """Max |decoded - original| (``measureMaxError``, ``:386-392``)."""
    return int(np.abs(decoded.astype(np.int32) - original.astype(np.int32)).max())


def measure_mean_error(decoded: np.ndarray, original: np.ndarray) -> float:
    """Mean L1 error (``measureMeanError``, ``:394-401``)."""
    return float(np.abs(decoded.astype(np.float64) - original.astype(np.float64)).mean())


def query_error(decoded: np.ndarray, original: np.ndarray) -> np.ndarray:
    """|error| as a renderable uint8 volume (``queryError``, ``:404-411``),
    the reference's error-field view (``main.cpp:285-292``)."""
    return np.abs(decoded.astype(np.int32) - original.astype(np.int32)).astype(np.uint8)


def to_preorder(tree: KdTree) -> np.ndarray:
    """The unbalanced preorder code stream (uint8 codes, unpacked) in the
    order of ``convertToPreorder``: node, left subtree, right subtree; a
    pruned (code 3) subtree is one node; a leaf's chain follows it.  Subtree
    sizes bottom-up, then preorder offsets top-down: pos(left) = pos(node) +
    1, pos(right) = pos(left) + size(left)."""
    D = tree.orig_depth
    sizes = _subtree_sizes(tree)
    out = np.empty(int(sizes[0][0]), dtype=np.uint8)

    gidx = np.zeros(1, dtype=np.int64)  # breadth-first indices of emitted nodes
    pos = np.zeros(1, dtype=np.int64)   # their preorder positions
    for d in range(D + 1):
        codes = tree.level_codes[d][gidx]
        out[pos] = codes
        if d < D:
            keep = codes != 3
            pg, pp = gidx[keep], pos[keep]
            left_pos = pp + 1
            gidx = np.empty(2 * pg.shape[0], dtype=np.int64)
            gidx[0::2], gidx[1::2] = 2 * pg, 2 * pg + 1
            pos = np.empty_like(gidx)
            pos[0::2], pos[1::2] = left_pos, left_pos + sizes[d + 1][2 * pg]
        else:
            chains = tree.chain_codes[gidx]
            lens = np.sum(chains != NO_NODE, axis=1)
            for step in range(chains.shape[1]):
                sel = lens > step
                if not sel.any():
                    break
                out[pos[sel] + 1 + step] = chains[sel, step]
    return out


FILE_HEADER = struct.Struct("<3q3qii4q")  # rootMin, rootMax, depths, X Y Z numActiveNodes


def save(tree: KdTree, path: str) -> None:
    """The reference binary format (``VolumeKdTree_recover.cpp:521-552``):
    rootMin (3 x i64, zeros) rootMax (3 x i64) maxTreeDepth (i32)
    origTreeDepth (i32) X Y Z numActiveNodes (4 x i64), the distance map
    (maxTreeDepth + 1 bytes), then the packed 2-bit codes."""
    X, Y, Z = tree.dims
    pre = to_preorder(tree)
    with open(path, "wb") as f:
        f.write(FILE_HEADER.pack(0, 0, 0, X, Y, Z, tree.max_depth, tree.orig_depth,
                                 X, Y, Z, len(pre)))
        f.write(np.asarray(tree.distance_map, dtype=np.uint8).tobytes())
        f.write(pack2_np(pre).tobytes())


def open_tree(path: str) -> dict:
    """Read a checkpoint's fields (the preorder codes unpacked).  A file
    shorter than its header says raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FILE_HEADER.size:
        raise ValueError(f"{path}: {len(data)} bytes, shorter than the header")
    f0 = FILE_HEADER.unpack_from(data)
    root_min, root_max = f0[0:3], f0[3:6]
    max_depth, orig_depth = f0[6], f0[7]
    X, Y, Z, num_active = f0[8:12]
    off = FILE_HEADER.size
    if len(data) < off + max_depth + 1 + (num_active + 3) // 4:
        raise ValueError(f"{path}: {len(data)} bytes, shorter than its {num_active} codes need")
    dm = np.frombuffer(data, dtype=np.uint8, count=max_depth + 1, offset=off)
    packed = np.frombuffer(data, dtype=np.uint8, offset=off + max_depth + 1)
    return dict(root_min=root_min, root_max=root_max, max_depth=max_depth,
                orig_depth=orig_depth, dims=(X, Y, Z), num_active_nodes=num_active,
                distance_map=np.array(dm), preorder=unpack2_np(packed, num_active))


def preorder_to_levels(preorder: np.ndarray, orig_depth: int, max_depth: int,
                       use_native: bool | None = None):
    """The inverse of :func:`to_preorder`: (level_codes, chain_codes) of an
    unpacked preorder stream, walked with the decoders' stack automaton
    (``reference_impl.decode_preorder``), each node's code recorded at its
    (depth, breadth-first index).  Unvisited slots (under pruned nodes) stay
    code 3 / ``NO_NODE``, which no consumer reads.

    ``use_native=None`` walks in ``csrc/kdtree_native.cu`` on a machine
    with a CUDA device (a failed build raises) and in Python elsewhere;
    ``True`` / ``False`` force either.  A stream that ends inside the tree
    raises ``ValueError``."""
    if use_native is None:
        use_native = torch.cuda.is_available()
    if use_native:
        from ..native import kdtree_native

        levels_flat, chains = kdtree_native.preorder_to_levels(preorder, orig_depth, max_depth)
    else:
        levels_flat, chains = _preorder_to_levels_py(preorder, orig_depth, max_depth)
    level_codes = [levels_flat[(1 << d) - 1:(1 << (d + 1)) - 1] for d in range(orig_depth + 1)]
    return level_codes, chains


def _preorder_to_levels_py(preorder: np.ndarray, orig_depth: int, max_depth: int):
    chain_len = max_depth - orig_depth
    levels_flat = np.full((1 << (orig_depth + 1)) - 1, 3, np.uint8)
    chains = np.full((1 << orig_depth, chain_len), NO_NODE, np.uint8)
    n = len(preorder)
    if n == 0:
        raise ValueError("an empty preorder stream")
    stack = [(0, 0, 0)]  # (preorder index, depth, breadth-first index)
    while stack:
        idx, depth, bf = stack[-1]
        code = int(preorder[idx])
        if depth <= orig_depth:
            levels_flat[(1 << depth) - 1 + bf] = code
        elif depth - orig_depth - 1 < chain_len:
            chains[bf, depth - orig_depth - 1] = code
        if code == 3 or depth == max_depth:
            stack.pop()
            if stack and idx + 1 >= n:
                raise ValueError("the preorder stream ends inside the tree")
            if idx + 1 < n and stack:
                _, pdep, pbf = stack.pop()
                stack.append((idx + 1, pdep + 1, 2 * pbf + 1))
        else:
            if idx + 1 >= n:
                raise ValueError("the preorder stream ends inside the tree")
            if depth >= orig_depth:
                stack.pop()
            stack.append((idx + 1, depth + 1, 2 * bf if depth < orig_depth else bf))
    return levels_flat, chains


def open_tree_full(path: str, verify: bool = True, use_native: bool | None = None) -> KdTree:
    """Open a checkpoint as a level-structured :class:`KdTree`, so a resumed
    tree keeps the compressed-domain path (device decode, block maxima from
    the tree, slab pools, cut-depth control).  ``verify`` serializes the
    rebuilt tree again and raises ``ValueError`` unless it equals the stored
    stream.  ``use_native`` as in :func:`preorder_to_levels`."""
    raw = open_tree(path)
    X, Y, Z = raw["dims"]
    orig_depth, max_depth = raw["orig_depth"], raw["max_depth"]
    level_codes, chains = preorder_to_levels(raw["preorder"], orig_depth, max_depth,
                                             use_native=use_native)
    tree = KdTree(dims=(X, Y, Z), orig_depth=orig_depth, max_depth=max_depth,
                  distance_map=raw["distance_map"].copy(), level_codes=level_codes,
                  chain_codes=chains, schedule=split_schedule(X, Y, Z),
                  num_active_nodes=raw["num_active_nodes"])
    if verify and not np.array_equal(to_preorder(tree), raw["preorder"]):
        raise ValueError(f"preorder round-trip mismatch for {path}")
    return tree
