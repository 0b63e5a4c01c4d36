"""The kd-tree build with its data-parallel passes on the device.

Counterpart of ``volumerenderer_tpu/codecs/device_build.py``
(``_encode_level_dev`` :41, ``_err_sq_chunks``/``_mean_sq_err_dev`` :57-69,
``_seed_parallel`` :72, ``_gd_fit_level_dev`` :93, ``build_device`` :123).
The host build (``codecs/kdtree.py``) runs the same four passes in numpy;
here they are torch operations on the volume's device, each over a level in
chunks of at most ``ENCODE_CHUNK`` nodes, so a 2048 x 2048 x 512 volume (2^31
leaves) builds in a few bytes a node beside the tree itself:

* pass 1, the midrange pyramid: pairwise min/max over the leaf order, which
  ``device.volume_leaf_order`` forms chunk by chunk;
* pass 2, the Δ fit per level: ``encodeNode`` over a level in exact int16,
  each node's parent estimate read at ``i >> 1`` of the level above's uint8
  recon, the level's squared error one exact int64 sum on the device divided
  by the node count on the host (JAX sums int32 chunk partials, a means to
  the same number), the gradient descent's scalar control flow on the host
  (``kdtree.fit_distance``, shared with the host build); each evaluation,
  and the final encode at the chosen Δ, is one ``vr.kd.encode`` span;
* pass 3, the prune: a boolean pyramid;
* pass 4, the chain growth: one masked step per chain level, a chunk of
  leaves at a time.

The Δ seeding is a running mean in level order.  ``seed_mode="exact"``
hands each level to ``kdtree.seed_level`` on the host (the compiled helper
``csrc/kdtree_seed.cu`` on a machine with a CUDA device, which reads the
level's truth bytes and its parent level's recon bytes as they are), one
``vr.kd.seed`` span a level, so the tree equals ``kdtree.build``'s array for
array.  ``seed_mode="parallel"`` takes JAX's float32 fixed point on the
device (:func:`_seed_parallel`); torch's float32 reductions add in another
order than XLA's, so its raw seed can differ from JAX's in the last bits
and, at a .5 boundary, round to the next integer.

The tree :func:`build_device` returns keeps its arrays on the device (the
levels' codes, the chains, the leaves' recon and truth as uint8 tensors)
and the seed of each level in ``tree.seeds``; ``device.to_device`` packs it
there.  :func:`to_host` gives the same tree in numpy, as ``kdtree.build``
returns it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.timer import span
from .device import volume_leaf_order
from .kdtree import (ADD_LEVEL_DISTANCES, MAX_ADD_LEVELS, NO_NODE, KdTree, fit_distance,
                     seed_level, split_schedule)

__all__ = ["build_device", "to_host", "ENCODE_CHUNK"]

ENCODE_CHUNK = 1 << 26  # nodes of a level a pass holds at a time


def _chunks(n: int):
    size = ENCODE_CHUNK
    for s in range(0, n, size):
        yield s, min(n, s + size)


def _parents(parent: torch.Tensor, s: int, e: int) -> torch.Tensor:
    """The parent estimates of nodes [s, e) of a level, int16: node i's is
    ``parent[i >> 1]`` of the level above's recon (the root's: one 0);
    ``s`` is even."""
    return parent[s >> 1:(e + 1) >> 1].to(torch.int16).repeat_interleave(2)[:e - s]


def _encode(t: torch.Tensor, p: torch.Tensor, distance: int):
    """``encodeNode`` of nodes with truth ``t`` and parent estimate ``p``
    (int16) in exact integers; tie order none > add > sub.  Returns (codes
    uint8, recon int16, min_err int16)."""
    none_err = (p - t).abs()
    add_est = torch.clamp(p + distance, max=255)
    add_err = (add_est - t).abs()
    sub_est = torch.clamp(p - distance, min=0)
    sub_err = (sub_est - t).abs()
    min_err = torch.minimum(sub_err, torch.minimum(none_err, add_err))
    codes = torch.where(none_err == min_err, 0,
                        torch.where(add_err == min_err, 1, 2)).to(torch.uint8)
    recon = torch.where(codes == 0, p, torch.where(codes == 1, add_est, sub_est))
    return codes, recon, min_err


def _sq_err_sum(truth: torch.Tensor, parent: torch.Tensor, distance: int) -> int:
    """The level's squared error at ``distance``: an exact int64 sum (at most
    255^2 a node), chunk by chunk on the device."""
    acc = torch.zeros((), dtype=torch.int64, device=truth.device)
    for s, e in _chunks(truth.shape[0]):
        _, _, err = _encode(truth[s:e].to(torch.int16), _parents(parent, s, e), distance)
        err = err.to(torch.int32)
        acc += torch.sum(err * err, dtype=torch.int64)
    return int(acc)


def _encode_level(truth: torch.Tensor, parent: torch.Tensor, distance: int):
    """(codes, recon) of a level at ``distance``, both uint8."""
    n = truth.shape[0]
    codes = torch.empty(n, dtype=torch.uint8, device=truth.device)
    recon = torch.empty(n, dtype=torch.uint8, device=truth.device)
    for s, e in _chunks(n):
        c, r, _ = _encode(truth[s:e].to(torch.int16), _parents(parent, s, e), distance)
        codes[s:e] = c
        recon[s:e] = r.to(torch.uint8)
    return codes, recon


def _seed_parallel(truth: torch.Tensor, parent: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """JAX's float32 fixed point for the running-mean seeding: one Δ,
    starting from the mean parent distance; each round re-decides which
    nodes take add/sub against it (ties go to none, as in the reference)
    and sets Δ to their mean parent distance.  ``parent`` holds each node's
    estimate.  Returns a 0-d float32 tensor."""
    t = truth.to(torch.float32)
    p = parent.to(torch.float32)
    pd = (p - t).abs()
    md = torch.clamp(pd.mean(), min=1e-6)
    for _ in range(iters):
        add_err = (torch.clamp(p + md, max=255.0) - t).abs()
        sub_err = (torch.clamp(p - md, min=0.0) - t).abs()
        min_err = torch.minimum(sub_err, torch.minimum(pd, add_err))
        chosen = min_err != pd
        s = torch.where(chosen, pd, 0.0).sum()
        c = chosen.sum()
        md = torch.where(c > 0, s / c, torch.zeros((), dtype=torch.float32, device=s.device))
    return md


def _fit_level(truth: torch.Tensor, parent: torch.Tensor, max_epochs: int, seed: float):
    """(distance, codes, recon) of one level: the host build's gradient
    descent, each error evaluated on the device (once per distinct Δ)."""
    n = truth.shape[0]

    @functools.cache
    def mean_sq_err(distance: int) -> float:
        with span("vr.kd.encode"):
            return _sq_err_sum(truth, parent, distance) / n

    dist = fit_distance(mean_sq_err, max_epochs, seed)
    with span("vr.kd.encode"):
        codes, recon = _encode_level(truth, parent, dist)
    return dist, codes, recon


def _pyramid(leaves: torch.Tensor, D: int) -> list:
    """The midrange of every node, level by level: a leaf's is its byte, an
    interior node's (min + max) // 2 of its leaves."""
    temp = [None] * (D + 1)
    temp[D] = leaves
    lmin = lmax = leaves
    for d in range(D - 1, -1, -1):
        lmin = torch.minimum(lmin[0::2], lmin[1::2])
        lmax = torch.maximum(lmax[0::2], lmax[1::2])
        mid = torch.empty_like(lmin)
        for s, e in _chunks(lmin.shape[0]):
            mid[s:e] = ((lmin[s:e].to(torch.int16) + lmax[s:e].to(torch.int16)) // 2).to(
                torch.uint8)
        temp[d] = mid
    return temp


def _prune(level_codes: list, recon: torch.Tensor, truth: torch.Tensor, tolerance: int) -> None:
    """A node becomes code 3 iff its code is 0, both children were pruned,
    and (leaves only) |recon − truth| < tolerance; in place."""
    D = len(level_codes) - 1
    leaf = level_codes[D]
    pruned = torch.empty(leaf.shape, dtype=torch.bool, device=leaf.device)
    for s, e in _chunks(leaf.shape[0]):
        err = (recon[s:e].to(torch.int16) - truth[s:e].to(torch.int16)).abs()
        pruned[s:e] = (leaf[s:e] == 0) & (err < tolerance)
        leaf[s:e].masked_fill_(pruned[s:e], 3)
    for d in range(D - 1, -1, -1):
        pruned = (level_codes[d] == 0) & pruned[0::2] & pruned[1::2]
        level_codes[d].masked_fill_(pruned, 3)


def _grow_chains(leaf_code: torch.Tensor, recon: torch.Tensor, truth: torch.Tensor,
                 tolerance: int) -> torch.Tensor:
    """The unary chains under the leaves, (num_leaves, MAX_ADD_LEVELS) uint8
    with ``NO_NODE`` for no node, a chunk of leaves at a time: one masked
    step per chain level on the Δ ladder; ``recon`` takes each leaf's final
    estimate in place."""
    n = leaf_code.shape[0]
    dev = leaf_code.device
    chains = torch.empty((n, MAX_ADD_LEVELS), dtype=torch.uint8, device=dev)
    col = torch.arange(MAX_ADD_LEVELS, device=dev)[None, :]
    for s, e in _chunks(n):
        t = truth[s:e].to(torch.int16)
        rm = recon[s:e].to(torch.int16)
        code = leaf_code[s:e]
        ch = torch.full((e - s, MAX_ADD_LEVELS), NO_NODE, dtype=torch.uint8, device=dev)
        active = (code != 3) & ((rm - t).abs() > tolerance)
        ch[:, 0].masked_fill_((code != 3) & ~active, 3)  # within tolerance: one terminal 3
        zero_start = torch.full((e - s,), -1, dtype=torch.int16, device=dev)
        for pos, dist in enumerate(ADD_LEVEL_DISTANCES):
            codes, new_rm, _ = _encode(t, rm, dist)
            rm = torch.where(active, new_rm, rm)  # only active leaves take this step
            ch[:, pos] = torch.where(active, codes, ch[:, pos])
            zero_start = torch.where(active & (codes == 0),
                                     torch.where(zero_start == -1, pos, zero_start),
                                     torch.where(active, -1, zero_start))
            still = (rm - t).abs() > tolerance
            if pos + 1 < MAX_ADD_LEVELS:
                ch[:, pos + 1].masked_fill_(active & ~still, 3)
            active = active & still
        # a chain's trailing run of zero codes becomes 3
        zs = zero_start[:, None]
        chains[s:e] = torch.where((zs >= 0) & (col >= zs) & (ch == 0), 3, ch)
        recon[s:e] = rm.to(torch.uint8)
    return chains


def _count_active(level_codes: list, chains: torch.Tensor) -> int:
    """numActiveNodes (``kdtree._count_active``): the nodes the preorder
    stream emits, a node under no code-3 ancestor, and the chain nodes of
    the emitted leaves whose code is not 3."""
    D = len(level_codes) - 1
    total = 1
    alive = torch.ones(1, dtype=torch.bool, device=chains.device)
    for d in range(D):
        live = alive & (level_codes[d] != 3)
        total += 2 * int(live.sum())
        alive = live.repeat_interleave(2)
    leaf_live = alive & (level_codes[D] != 3)
    for s, e in _chunks(chains.shape[0]):
        lengths = (chains[s:e] != NO_NODE).sum(dim=1)
        total += int(lengths[leaf_live[s:e]].sum())
    return total


def build_device(volume, tolerance: int = 6, max_epochs: int = 5, seed_mode: str = "exact",
                 device: torch.device | str = "cuda") -> KdTree:
    """Compress a (Z, Y, X) uint8 volume (numpy array or tensor) with the
    passes on ``device``.  Returns a ``KdTree`` whose arrays are tensors on
    ``device`` (see the module's docstring), which ``to_device``,
    ``CompressedRenderer`` and ``DiffDecoder`` take as they take
    ``kdtree.build``'s; in ``seed_mode="exact"`` the two are equal array for
    array (:func:`to_host`).  The whole build is one ``vr.kd.build`` span."""
    if seed_mode not in ("exact", "parallel"):
        raise ValueError(f"seed_mode must be 'exact' or 'parallel', got {seed_mode!r}")
    if isinstance(volume, torch.Tensor):
        if volume.dtype != torch.uint8:
            raise ValueError(f"expected a uint8 volume, got {volume.dtype}")
        vol = volume.to(device)
    else:
        vol = torch.from_numpy(np.ascontiguousarray(volume, dtype=np.uint8)).to(device)
    with span("vr.kd.build"):
        return _build(vol, tolerance, max_epochs, seed_mode)


def _build(vol: torch.Tensor, tolerance: int, max_epochs: int, seed_mode: str) -> KdTree:
    Z, Y, X = vol.shape
    schedule = split_schedule(X, Y, Z)
    D = len(schedule)
    max_depth = D + MAX_ADD_LEVELS

    # PASS 1: the midrange pyramid
    temp = _pyramid(volume_leaf_order(vol, schedule), D)

    # PASS 2: Δ fit per level
    distance_map = np.zeros(max_depth + 1, dtype=np.uint8)
    seeds = np.zeros(D + 1, dtype=np.float64)
    level_codes = []
    recon = torch.zeros(1, dtype=torch.uint8, device=vol.device)  # the root's estimate is 0
    for d in range(D + 1):
        truth = temp[d]
        if seed_mode == "exact":
            with span("vr.kd.seed"):
                seed = seed_level(truth.cpu().numpy(), recon.cpu().numpy(), shift=1)
        else:
            parent = recon.repeat_interleave(2)[:truth.shape[0]]
            seed = float(np.floor(float(_seed_parallel(truth, parent)) + 0.5))
        seeds[d] = seed
        dist, codes, recon = _fit_level(truth, recon, max_epochs, seed)
        distance_map[d] = dist
        level_codes.append(codes)
        if d < D:
            temp[d] = None
    for i, dist in enumerate(ADD_LEVEL_DISTANCES):
        distance_map[D + 1 + i] = dist

    # PASS 3: the prune pyramid; PASS 4: chain growth
    leaf_truth = temp[D]
    _prune(level_codes, recon, leaf_truth, tolerance)
    chains = _grow_chains(level_codes[D], recon, leaf_truth, tolerance)

    tree = KdTree(
        dims=(X, Y, Z), orig_depth=D, max_depth=max_depth, distance_map=distance_map,
        level_codes=level_codes, chain_codes=chains, schedule=schedule, tolerance=tolerance,
        max_epochs=max_epochs, leaf_recon=recon, leaf_truth=leaf_truth)
    tree.num_active_nodes = _count_active(level_codes, chains)
    tree.seeds = seeds
    return tree


def to_host(tree: KdTree) -> KdTree:
    """The tree with its tensors brought to numpy (the leaves' recon as
    int32), as ``kdtree.build`` returns it; ``seeds`` kept."""

    def host(a, dtype=None):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        return a if a is None or dtype is None else a.astype(dtype)

    out = KdTree(
        dims=tree.dims, orig_depth=tree.orig_depth, max_depth=tree.max_depth,
        distance_map=host(tree.distance_map), level_codes=[host(c) for c in tree.level_codes],
        chain_codes=host(tree.chain_codes), schedule=tree.schedule, tolerance=tree.tolerance,
        max_epochs=tree.max_epochs, num_active_nodes=tree.num_active_nodes,
        leaf_recon=host(tree.leaf_recon, np.int32), leaf_truth=host(tree.leaf_truth))
    if hasattr(tree, "seeds"):
        out.seeds = tree.seeds
    return out
