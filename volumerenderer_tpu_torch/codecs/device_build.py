"""The kd-tree build with its data-parallel passes on the device.

Counterpart of ``volumerenderer_tpu/codecs/device_build.py``
(``_encode_level_dev`` :41, ``_err_sq_chunks``/``_mean_sq_err_dev`` :57-69,
``_seed_parallel`` :72, ``_gd_fit_level_dev`` :93, ``build_device`` :123).
The host build (``codecs/kdtree.py``) runs the same four passes in numpy;
here they are torch operations on the volume's device:

* pass 1, the midrange pyramid: pairwise min/max over the leaf order, which
  is one reshape of the volume to (2,)*D and a permute;
* pass 2, the Δ fit per level: ``encodeNode`` over a level in exact int32,
  the level's squared error one exact int64 sum on the device divided by the
  node count on the host (JAX sums int32 chunk partials, a means to the same
  number), the gradient descent's scalar control flow on the host
  (``kdtree.fit_distance``, shared with the host build);
* pass 3, the prune: a boolean pyramid;
* pass 4, the chain growth: one masked step per chain level.

The Δ seeding is a running mean in level order.  ``seed_mode="exact"``
hands each level to ``kdtree.seed_level`` on the host (the compiled helper
``csrc/kdtree_seed.cu`` on a machine with a CUDA device), so the tree equals
``kdtree.build``'s array for array.  ``seed_mode="parallel"`` takes JAX's
float32 fixed point on the device (:func:`_seed_parallel`); torch's float32
reductions add in another order than XLA's, so its raw seed can differ from
JAX's in the last bits and, at a .5 boundary, round to the next integer.

Pass 1's leaf order is one reshape to (2,)*D: CUDA copies take up to 25
dims, so :func:`build_device` takes volumes up to 2^25 voxels (e.g.
512 x 256 x 256) and raises beyond.
"""
from __future__ import annotations

import numpy as np
import torch

from .kdtree import (ADD_LEVEL_DISTANCES, MAX_ADD_LEVELS, NO_NODE, KdTree, _count_active,
                     _leaf_axes_perm, fit_distance, seed_level, split_schedule)

__all__ = ["build_device", "MAX_LEAF_ORDER_DIMS"]

MAX_LEAF_ORDER_DIMS = 25  # dims of a tensor a CUDA copy takes


def _encode_level_dev(truth: torch.Tensor, parent: torch.Tensor, distance: int):
    """``encodeNode`` over a level in exact int32; tie order none > add > sub.
    Returns (codes uint8, recon int32, min_err int32)."""
    t = truth.to(torch.int32)
    p = parent.to(torch.int32)
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


def _mean_sq_err_dev(truth: torch.Tensor, parent: torch.Tensor, distance: int) -> float:
    """The level's mean squared error: an exact int64 sum (at most 255^2 per
    node) over the node count, as the host build's."""
    _, _, e = _encode_level_dev(truth, parent, distance)
    e = e.to(torch.int64)
    return int(torch.sum(e * e)) / truth.shape[0]


def _seed_parallel(truth: torch.Tensor, parent: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """JAX's float32 fixed point for the running-mean seeding: one Δ,
    starting from the mean parent distance; each round re-decides which
    nodes take add/sub against it (ties go to none, as in the reference)
    and sets Δ to their mean parent distance.  Returns a 0-d float32
    tensor."""
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


def _gd_fit_level_dev(truth, parent, max_epochs: int, seed: float):
    """(distance, codes, recon) of one level: the host build's gradient
    descent, each error evaluated on the device."""
    dist = fit_distance(lambda d: _mean_sq_err_dev(truth, parent, d), max_epochs, seed)
    codes, recon, _ = _encode_level_dev(truth, parent, dist)
    return dist, codes, recon


def build_device(volume, tolerance: int = 6, max_epochs: int = 5, seed_mode: str = "exact",
                 device: torch.device | str = "cuda") -> KdTree:
    """Compress a (Z, Y, X) uint8 volume (numpy array or tensor) with the
    passes on ``device``.  Returns a host ``KdTree`` (the codes brought
    back), which ``to_device``, ``CompressedRenderer`` and ``DiffDecoder``
    take as they take ``kdtree.build``'s; in ``seed_mode="exact"`` the two
    are equal array for array."""
    if seed_mode not in ("exact", "parallel"):
        raise ValueError(f"seed_mode must be 'exact' or 'parallel', got {seed_mode!r}")
    if isinstance(volume, torch.Tensor):
        if volume.dtype != torch.uint8:
            raise ValueError(f"expected a uint8 volume, got {volume.dtype}")
        vol = volume.to(device)
    else:
        vol = torch.from_numpy(np.ascontiguousarray(volume, dtype=np.uint8)).to(device)
    Z, Y, X = vol.shape
    schedule = split_schedule(X, Y, Z)
    D = len(schedule)
    if D > MAX_LEAF_ORDER_DIMS:
        raise ValueError(f"build_device takes up to 2^{MAX_LEAF_ORDER_DIMS} voxels (its leaf "
                         f"order is one reshape to (2,)*D); got {X}x{Y}x{Z}, D = {D}")
    max_depth = D + MAX_ADD_LEVELS

    # PASS 1: the midrange pyramid
    perm, (nz, ny, nx) = _leaf_axes_perm(X, Y, Z, schedule)
    leaves = vol.reshape((2,) * (nz + ny + nx)).permute(perm).reshape(-1)
    temp = [None] * (D + 1)
    temp[D] = leaves
    lmin = lmax = leaves
    for d in range(D - 1, -1, -1):
        lmin = torch.minimum(lmin[0::2], lmin[1::2])
        lmax = torch.maximum(lmax[0::2], lmax[1::2])
        temp[d] = ((lmin.to(torch.int32) + lmax.to(torch.int32)) // 2).to(torch.uint8)

    # PASS 2: Δ fit per level
    distance_map = np.zeros(max_depth + 1, dtype=np.uint8)
    level_codes = []
    recon = None
    for d in range(D + 1):
        truth = temp[d]
        parent = torch.zeros(1, dtype=torch.int32, device=vol.device) if d == 0 \
            else recon.repeat_interleave(2)
        if seed_mode == "exact":
            seed = seed_level(truth.cpu().numpy(), parent.cpu().numpy())
        else:
            seed = float(np.floor(float(_seed_parallel(truth, parent)) + 0.5))
        dist, codes, recon = _gd_fit_level_dev(truth, parent, max_epochs, seed)
        distance_map[d] = dist
        level_codes.append(codes)
    for i, dist in enumerate(ADD_LEVEL_DISTANCES):
        distance_map[D + 1 + i] = dist

    # PASS 3: the prune pyramid
    leaf_truth = temp[D].to(torch.int32)
    pruned = (level_codes[D] == 0) & ((recon - leaf_truth).abs() < tolerance)
    level_codes[D] = torch.where(pruned, 3, level_codes[D]).to(torch.uint8)
    for d in range(D - 1, -1, -1):
        pruned = (level_codes[d] == 0) & pruned[0::2] & pruned[1::2]
        level_codes[d] = torch.where(pruned, 3, level_codes[d]).to(torch.uint8)

    # PASS 4: chain growth, one masked step per chain level
    n = 1 << D
    chains = torch.full((n, MAX_ADD_LEVELS), NO_NODE, dtype=torch.uint8, device=vol.device)
    rm = recon
    leaf_code = level_codes[D]
    active = (leaf_code != 3) & ((rm - leaf_truth).abs() > tolerance)
    needs_terminal = (leaf_code != 3) & ~active
    chains[:, 0] = torch.where(needs_terminal, 3, chains[:, 0])
    zero_start = torch.full((n,), -1, dtype=torch.int32, device=vol.device)
    for pos in range(MAX_ADD_LEVELS):
        codes, new_rm, _ = _encode_level_dev(leaf_truth, rm, int(distance_map[D + 1 + pos]))
        rm = torch.where(active, new_rm, rm)   # only active leaves take this step
        chains[:, pos] = torch.where(active, codes, chains[:, pos])
        zero_start = torch.where(active & (codes == 0),
                                 torch.where(zero_start == -1, pos, zero_start),
                                 torch.where(active, -1, zero_start))
        still = (rm - leaf_truth).abs() > tolerance
        if pos + 1 < MAX_ADD_LEVELS:
            chains[:, pos + 1] = torch.where(active & ~still, 3, chains[:, pos + 1])
        active = active & still
    # a chain's trailing run of zero codes becomes 3
    col = torch.arange(MAX_ADD_LEVELS, device=vol.device)[None, :]
    zs = zero_start[:, None]
    chains = torch.where((zs >= 0) & (col >= zs) & (chains == 0), 3, chains).to(torch.uint8)

    tree = KdTree(
        dims=(X, Y, Z), orig_depth=D, max_depth=max_depth, distance_map=distance_map,
        level_codes=[c.cpu().numpy() for c in level_codes], chain_codes=chains.cpu().numpy(),
        schedule=schedule, tolerance=tolerance, max_epochs=max_epochs,
        leaf_recon=rm.to(torch.int32).cpu().numpy(), leaf_truth=temp[D].cpu().numpy())
    tree.num_active_nodes = _count_active(tree)
    return tree
