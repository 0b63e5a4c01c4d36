"""Sequential scalar implementation of the progressive kd-tree codec.

Counterpart of ``volumerenderer_tpu/codecs/reference_impl.py``: a close
transliteration of the reference control flow (``VolumeKdTree_recover.cpp``)
in Python and numpy, which

* handles any volume dimensions, powers of two or not, where the
  split-dimension skip rule makes per-node extents uneven
  (``buildRecursive``, ``:151-159``) and the vectorized codec of
  ``kdtree.py`` does not apply (the reference's own run is 2048x2048x768);
* is the oracle of the vectorized codec and of the native passes
  (``csrc/kdtree_native.cu``): the same distance map, preorder stream and
  level cuts.

It shares the two documented fixes of ``kdtree.py`` (a fresh
``currentError`` per evaluation; a final re-encode at the chosen Δ).  The
Python walks are O(nodes) and meant for small volumes.

:func:`decode_preorder` and :func:`build_arbitrary` take ``use_native``:
``None`` runs the native pass on a machine with a CUDA device (its library
is built with ``nvcc``; a failed build raises) and the Python walk
elsewhere; ``True`` / ``False`` force either.  The JAX package picks the
native decode by volume size and gives way to Python on any ``ImportError``
or ``OSError`` of its library (``reference_impl.py:290-296, 371-389``);
here nothing falls back.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .kdtree import ADD_LEVEL_DISTANCES, GAMMA, H, MAX_ABS_STEP, MAX_ADD_LEVELS

__all__ = ["SequentialKdTree", "decode_preorder", "build_arbitrary"]


class SequentialKdTree:
    """Transliteration of class ``VolumeKdtree`` (recover variant).
    ``build()`` fills ``orig_depth``, ``max_depth``, ``distance_map``,
    ``preorder`` (unpacked codes), ``num_active_nodes`` and ``recon`` (the
    leaves' reconstructions)."""

    def __init__(self, data: np.ndarray, X: int, Y: int, Z: int,
                 tolerance: int = 6, max_epochs: int = 5):
        self.data = np.asarray(data, dtype=np.uint8).reshape(-1)  # x-fastest
        self.X, self.Y, self.Z = X, Y, Z
        self.tolerance = tolerance
        self.max_epochs = max_epochs

    # -- PASS 1 ------------------------------------------------------------ #

    def build(self):
        X, Y, Z = self.X, self.Y, self.Z
        # (int)(log(X)/log(2)) exactly as the C++ (:26-28)
        nx = int(math.log(X) / math.log(2))
        ny = int(math.log(Y) / math.log(2))
        nz = int(math.log(Z) / math.log(2))
        self.orig_depth = D = nx + ny + nz
        self.max_depth = D + MAX_ADD_LEVELS
        self.distance_map = np.zeros(self.max_depth + 1, dtype=np.uint8)
        self.num_orig_nodes = (1 << (D + 1)) - 1
        self.temp = np.zeros(self.num_orig_nodes, dtype=np.uint8)
        self.first_orig_leaf = (1 << D) - 1

        self._build_recursive(0, 0, [0, 0, 0], [X, Y, Z])

        self.tree = np.zeros(self.num_orig_nodes, dtype=np.uint8)
        self._compress_gradient_descent()

        # keep only leaves of temp (:64-66)
        self.temp = self.temp[self.first_orig_leaf:]

        self._prune_recursive(0)

        add = list(ADD_LEVEL_DISTANCES)
        for i, depth in enumerate(range(D + 1, self.max_depth + 1)):
            self.distance_map[depth] = add[i]

        self._convert_to_preorder()

    def _get_cell(self, x, y, z):
        return x + self.X * y + self.X * self.Y * z

    def _build_recursive(self, idx, depth, min_b, max_b):
        if depth < self.orig_depth:
            split = depth % 3
            ext = [max_b[i] - min_b[i] for i in range(3)]
            num_cells = ext[0] * ext[1] * ext[2]
            i = 0
            while num_cells > 1 and ext[split] == 1:
                i += 1
                split = (depth + i) % 3
            mid = (min_b[split] + max_b[split]) // 2
            hi = max_b[split]

            lmax = list(max_b); lmax[split] = mid
            lo_rng = self._build_recursive(2 * idx + 1, depth + 1, list(min_b), lmax)
            lmin = list(min_b); lmin[split] = mid
            hmax = list(max_b); hmax[split] = hi
            hi_rng = self._build_recursive(2 * idx + 2, depth + 1, lmin, hmax)
            mn = min(lo_rng[0], hi_rng[0])
            mx = max(lo_rng[1], hi_rng[1])
        else:
            v = int(self.data[self._get_cell(min_b[0], min_b[1], min_b[2])])
            mn = mx = v
        self.temp[idx] = int((mx + mn) / 2.0)
        return (mn, mx)

    # -- PASS 2 ------------------------------------------------------------ #

    def _encode_node_estimate(self, idx, parent, state):
        t = float(self.temp[idx])
        pe = float(parent)
        pd = abs(pe - t)
        md = (state[0] + pd) / (state[1] + 1.0)
        none_err = pd
        add_est = min(255.0, pe + md)
        add_err = abs(add_est - t)
        sub_est = max(0.0, pe - md)
        sub_err = abs(sub_est - t)
        min_err = min(sub_err, min(none_err, add_err))
        if min_err == none_err:
            return int(pe)
        if min_err == add_err:
            state[0] += pd; state[1] += 1.0
            return int(add_est)
        state[0] += pd; state[1] += 1.0
        return int(sub_est)

    def _encode_node(self, idx, parent, dist, fill, truth=None):
        t = float(self.temp[idx]) if truth is None else float(truth)
        pe = float(parent)
        pd = abs(pe - t)
        none_err = pd
        add_est = min(255.0, pe + dist)
        add_err = abs(add_est - t)
        sub_est = max(0.0, pe - dist)
        sub_err = abs(sub_est - t)
        min_err = min(sub_err, min(none_err, add_err))
        if min_err == none_err:
            if fill:
                self.tree[idx] = 0
            return int(pe), min_err
        if min_err == add_err:
            if fill:
                self.tree[idx] = 1
            return int(add_est), min_err
        if fill:
            self.tree[idx] = 2
        return int(sub_est), min_err

    def _compress_gradient_descent(self):
        start = 0
        parent_start = 0
        recon_parents = None
        for depth in range(self.orig_depth + 1):
            n = 1 << depth
            end = start + n
            recon = np.zeros(n, dtype=np.int64)

            state = [0.0, 0.0]
            for i in range(start, end):
                parent = 0 if i == 0 else recon_parents[((i - 1) // 2) - parent_start]
                self._encode_node_estimate(i, parent, state)
            cur_dist = math.floor(state[0] / state[1] + 0.5) if state[1] > 0 else 0.0

            def eval_dist(dist, fill):
                err = 0.0
                for i in range(start, end):
                    parent = 0 if i == 0 else recon_parents[((i - 1) // 2) - parent_start]
                    r, e = self._encode_node(i, parent, dist, fill)
                    if fill:
                        recon[i - start] = r
                    err += e * e
                return err / n

            epoch = 0
            prev_dist, prev_step, prev_err = 0.0, 255.0, 65025.0
            cur_err = cur_df = cur_step = 0.0
            while epoch < self.max_epochs and abs(prev_step) >= 0.5:
                if epoch != 0:
                    prev_dist = cur_dist
                    prev_err = cur_err
                    prev_df = cur_df
                    prev_step = cur_step
                    cur_dist = math.floor(min(255.0, max(0.0, prev_dist + prev_step)) + 0.5)
                    if cur_dist == prev_dist:
                        break
                cur_err = eval_dist(cur_dist, True)
                if cur_err < 1.0:
                    break
                if epoch != 0 and cur_err > prev_err:
                    cur_err = prev_err
                    cur_dist = prev_dist
                    cur_df = prev_df
                    cur_step = prev_step / 2.0
                    epoch += 1
                    continue
                e_lo = eval_dist(int(max(0.0, cur_dist - H)), False)
                e_hi = eval_dist(int(min(255.0, cur_dist + H)), False)
                cur_df = (e_hi - e_lo) / (2.0 * H)
                cur_step = max(-MAX_ABS_STEP, min(MAX_ABS_STEP, -GAMMA * cur_df))
                epoch += 1

            self.distance_map[depth] = int(cur_dist)
            eval_dist(int(cur_dist), True)  # final re-encode (documented fix)

            recon_parents = recon
            parent_start = start
            start = end
        self.recon = recon.astype(np.int64)  # leaf reconstructions

    # -- PASS 3 ------------------------------------------------------------ #

    def _prune_recursive(self, root):
        depth = int(math.floor(math.log2(root + 1)))
        left = right = True
        meets = True
        if depth < self.orig_depth:
            left = self._prune_recursive(2 * root + 1)
            right = self._prune_recursive(2 * root + 2)
        if depth == self.orig_depth:
            i = root - self.first_orig_leaf
            meets = abs(int(self.recon[i]) - int(self.temp[i])) < self.tolerance
        if left and right and self.tree[root] == 0 and meets:
            self.tree[root] = 3
            return True
        return False

    # -- PASS 4 ------------------------------------------------------------ #

    def _convert_to_preorder(self):
        """Stack walk of ``convertToPreorder`` (``:631-724``)."""
        out = []
        stack = [(0, 0, False, -1)]  # idx, depth, eval, zeroStartIdx
        while stack:
            idx, depth, ev, zero_start = stack.pop()
            code = int(self.tree[idx])
            if depth >= self.orig_depth:
                ri = idx - self.first_orig_leaf
                if ev:
                    r, _ = self._encode_node(idx, self.recon[ri],
                                             int(self.distance_map[depth]), True,
                                             truth=self.temp[ri])
                    self.recon[ri] = r
                    code = int(self.tree[idx])
                    if zero_start != -1:
                        if code != 0:
                            zero_start = -1
                    else:
                        if code == 0:
                            zero_start = len(out)
                else:
                    if depth > self.orig_depth:
                        code = 3
            out.append(code)

            if depth >= self.max_depth or code == 3:
                if zero_start != -1:
                    for i in range(zero_start, len(out)):
                        out[i] = 3
                continue

            if depth >= self.orig_depth:
                if abs(int(self.recon[ri]) - int(self.temp[ri])) > self.tolerance:
                    stack.append((idx, depth + 1, True, zero_start))
                else:
                    stack.append((idx, depth + 1, False, zero_start))
                continue

            stack.append((2 * idx + 2, depth + 1, False, zero_start))
            stack.append((2 * idx + 1, depth + 1, False, zero_start))

        self.num_active_nodes = len(out)
        self.preorder = np.array(out, dtype=np.uint8)

    # -- decode ------------------------------------------------------------ #

    def level_cut(self, cut_depth: int, use_native: bool | None = None) -> np.ndarray:
        return decode_preorder(self.preorder, self.distance_map,
                               self.X, self.Y, self.Z,
                               self.orig_depth, self.max_depth, cut_depth,
                               use_native=use_native)


def _depths(X: int, Y: int, Z: int) -> tuple[int, int]:
    """(orig_depth, max_depth): (int)(log(n)/log(2)) per axis, as the C++
    computes them (``:26-28``)."""
    D = sum(int(math.log(n) / math.log(2)) for n in (X, Y, Z))
    return D, D + MAX_ADD_LEVELS


def decode_preorder(preorder: np.ndarray, distance_map: np.ndarray,
                    X: int, Y: int, Z: int, orig_depth: int, max_depth: int,
                    cut_depth: int, use_native: bool | None = None) -> np.ndarray:
    """Stack-machine transliteration of ``levelCut``
    (``VolumeKdTree_recover.cpp:726-835``), decoding a preorder code stream
    (as the reference's file stores it) into a dense (Z, Y, X) volume.

    A latent reference bug is fixed as in the JAX package: the C++ treats
    ``depth == cutDepth`` as a leaf and then takes ``idx + 1`` for a right
    sibling, but in preorder it is the truncated node's own left child, so a
    cut below the full depth desyncs the walk (``:756,769-771``;
    ``main.cpp:281`` only cuts at ``maxTreeDepth``).  The walk follows the
    full structure and freezes the scalars below the cut: the same output at
    ``cut == maxTreeDepth``, the intended truncation below it (as
    ``kdtree.level_cut``).  A stream that ends inside the tree raises
    ``ValueError``."""
    if use_native is None:
        use_native = torch.cuda.is_available()
    if use_native:
        from ..native import kdtree_native

        return kdtree_native.decode_preorder(preorder, distance_map, X, Y, Z, orig_depth,
                                             max_depth, cut_depth)

    out = np.zeros(X * Y * Z, dtype=np.uint8)
    num_active = len(preorder)
    if num_active == 0:
        raise ValueError("an empty preorder stream")

    def child_scalar(scalar, code, parent_depth):
        d = parent_depth + 1
        if d > cut_depth:
            return scalar  # frozen below the cut
        if code == 1:
            return int(min(255.0, scalar + float(distance_map[d])))
        if code == 2:
            return int(max(0.0, scalar - float(distance_map[d])))
        return scalar

    def split_box(min_b, max_b, depth, which):
        min_b, max_b = list(min_b), list(max_b)
        ext = [max_b[i] - min_b[i] for i in range(3)]
        if ext[0] * ext[1] * ext[2] > 1:
            sd = depth % 3
            i = 0
            while ext[sd] == 1:
                i += 1
                sd = (depth + i) % 3
            if which == "left":
                max_b[sd] = (min_b[sd] + max_b[sd]) // 2
            else:
                min_b[sd] = (min_b[sd] + max_b[sd]) // 2
        return min_b, max_b

    vol = out.reshape(Z, Y, X)
    stack = [(0, 0, int(distance_map[0]), [0, 0, 0], [X, Y, Z])]
    while stack:
        idx, depth, scalar, min_b, max_b = stack[-1]
        code = int(preorder[idx])

        if code == 3 or depth == max_depth:
            vol[min_b[2]:max_b[2], min_b[1]:max_b[1], min_b[0]:max_b[0]] = scalar
            stack.pop()
            nxt = idx + 1
            if stack and nxt >= num_active:
                raise ValueError("the preorder stream ends inside the tree")
            if nxt < num_active and stack:
                idx, depth, scalar, min_b, max_b = stack.pop()
                scalar = child_scalar(scalar, int(preorder[nxt]), depth)
                min_b, max_b = split_box(min_b, max_b, depth, "right")
                stack.append((nxt, depth + 1, scalar, min_b, max_b))
        else:
            nxt = idx + 1
            if nxt >= num_active:
                raise ValueError("the preorder stream ends inside the tree")
            if depth >= orig_depth:
                stack.pop()
            scalar = child_scalar(scalar, int(preorder[nxt]), depth)
            min_b, max_b = split_box(min_b, max_b, depth, "left")
            stack.append((nxt, depth + 1, scalar, min_b, max_b))
    return vol


def build_arbitrary(volume: np.ndarray, tolerance: int = 6, max_epochs: int = 5,
                    use_native: bool | None = None) -> SequentialKdTree:
    """The full build of a (Z, Y, X) uint8 volume of any dimensions, in
    ``csrc/kdtree_native.cu`` or in :meth:`SequentialKdTree.build` (see the
    module docstring for ``use_native``); both give the same tree.  Returns
    a ``SequentialKdTree`` with ``preorder``, ``distance_map``,
    ``num_active_nodes``, ``recon`` and ``level_cut``."""
    volume = np.asarray(volume, dtype=np.uint8)
    if volume.ndim != 3:
        raise ValueError(f"expected a (Z, Y, X) volume, got {volume.shape}")
    Z, Y, X = volume.shape
    tree = SequentialKdTree(volume.reshape(-1), X, Y, Z, tolerance, max_epochs)
    if use_native is None:
        use_native = torch.cuda.is_available()
    if not use_native:
        tree.build()
        return tree

    from ..native import kdtree_native
    from ..utils.bitarray import unpack2_np

    D, max_depth = _depths(X, Y, Z)
    dm = np.zeros(max_depth + 1, dtype=np.uint8)
    dm[D + 1:] = ADD_LEVEL_DISTANCES
    n_active, packed, dm, leaf_recon = kdtree_native.build_full(volume, tolerance, max_epochs, D,
                                                                max_depth, dm)
    tree.orig_depth = D
    tree.max_depth = max_depth
    tree.distance_map = dm
    tree.num_active_nodes = n_active
    tree.preorder = unpack2_np(packed, n_active)
    tree.recon = leaf_recon.astype(np.int64)
    return tree
