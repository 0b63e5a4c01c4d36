"""Mid-range dual-tree codec, built on the host with numpy.

Counterpart of ``volumerenderer_tpu/codecs/midrange.py`` (the reference's
``MidRangeTree``, ``MidRangeTree.cpp``), on the port's kd-tree machinery
(``codecs/kdtree.py``):

* every node carries two values, the midpoint ``(max + min) / 2`` and the
  half-range ``(max - min) / 2`` (``MidRangeTree.cpp:233-236``); leaves have
  range 0;
* two independent distance maps and 2-bit code trees, fit by the same
  seeding and gradient descent (``compressGradientDescent[_range]``,
  ``:245-544``).  The reference's range pass guards a central difference
  the loop never uses afterwards, so the codes are those of the unguarded
  fit, and the midpoint channel is bit-identical to ``kdtree.build``'s tree;
* prune and chain growth are decided by the midpoint channel alone
  (``pruneTreeRecursive``, ``:857-868``; ``convertToPreorder``, ``:946-957``)
  and set codes in both trees in lockstep (``:905,921,929,940``);
* ``levelCut`` decodes the midpoint tree only (``:984-1093``); the range
  decode is :func:`level_cut_range`.

``to_device_pair`` puts both channels on a device for ``codecs/device.py``'s
decode; ``models.CompressedRenderer`` renders a ``MidRangeTree``'s midpoint
channel.  ``save`` / ``open_tree`` are the reference's dual-tree file
(``MidRangeTree.cpp:753-786``) and ``convert_to_byte_array`` its
interleaved texture layout (``:1095-1128``), byte for byte the JAX
package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.bitarray import pack2_np, unpack2_np
from . import kdtree as K

__all__ = ["MidRangeTree", "build", "level_cut", "level_cut_range", "to_device_pair",
           "to_preorder_pair", "save", "open_tree", "convert_to_byte_array"]


@dataclasses.dataclass
class MidRangeTree:
    """The two channels of the tree: ``mid``, a ``KdTree`` that owns the
    structure (its level and chain codes), and the range channel's distance
    map and codes on the same structure, with its build-time leaf recon and
    truth.  The fields are the JAX package's ``MidRangeTree``'s
    (``interop.midrange_from_numpy`` carries one across)."""

    mid: K.KdTree
    range_distance_map: np.ndarray
    range_level_codes: list[np.ndarray]
    range_chain_codes: np.ndarray | None
    leaf_recon_range: np.ndarray | None = None
    leaf_truth_range: np.ndarray | None = None

    @property
    def num_active_nodes(self) -> int:
        return self.mid.num_active_nodes


def _fit_levels(temp: list[np.ndarray], max_epochs: int):
    """Per-depth Δ fit and encode of one channel's node values ``temp``
    (``temp[d]`` of the 2^d nodes at depth d): (Δ per depth, codes per depth,
    the leaves' recon), as ``kdtree.build`` fits the midpoint channel."""
    dists, codes, recon = [], [], None
    for d, truth in enumerate(temp):
        parent = np.zeros(1, dtype=np.int32) if d == 0 else np.repeat(recon, 2)
        dist, c, recon = K.gd_fit_level(truth, parent, max_epochs, K.seed_level(truth, parent))
        dists.append(dist)
        codes.append(c)
    return dists, codes, recon


def build(volume: np.ndarray, tolerance: int = 6, max_epochs: int = 5) -> MidRangeTree:
    """Compress a (Z, Y, X) uint8 volume into both channels: the min/max
    pyramid, the two Δ fits, the prune and the chain growth decided by the
    midpoint channel and applied to both."""
    volume = np.asarray(volume, dtype=np.uint8)
    Z, Y, X = volume.shape
    schedule = K.split_schedule(X, Y, Z)
    D = len(schedule)
    max_depth = D + K.MAX_ADD_LEVELS

    # PASS 1: the min/max pyramid -> (midpoint, half-range) per node
    leaves = K.volume_to_leaves(volume, schedule)
    temp_mid: list[np.ndarray] = [None] * (D + 1)
    temp_rng: list[np.ndarray] = [None] * (D + 1)
    temp_mid[D] = leaves
    temp_rng[D] = np.zeros_like(leaves)
    lmin = lmax = leaves
    for d in range(D - 1, -1, -1):
        lmin = np.minimum(lmin[0::2], lmin[1::2])
        lmax = np.maximum(lmax[0::2], lmax[1::2])
        temp_mid[d] = ((lmin.astype(np.uint16) + lmax) // 2).astype(np.uint8)
        temp_rng[d] = ((lmax.astype(np.int16) - lmin) // 2).astype(np.uint8)

    # PASS 2: two independent Δ fits over the same structure, then the fixed
    # Δ ladder of the chain levels in both maps
    dists_m, codes_mid, recon_m = _fit_levels(temp_mid, max_epochs)
    dists_r, codes_rng, recon_r = _fit_levels(temp_rng, max_epochs)
    dm_mid = np.zeros(max_depth + 1, dtype=np.uint8)
    dm_rng = np.zeros(max_depth + 1, dtype=np.uint8)
    dm_mid[:D + 1] = dists_m
    dm_rng[:D + 1] = dists_r
    dm_mid[D + 1:] = K.ADD_LEVEL_DISTANCES
    dm_rng[D + 1:] = K.ADD_LEVEL_DISTANCES

    mid = K.KdTree(dims=(X, Y, Z), orig_depth=D, max_depth=max_depth, distance_map=dm_mid,
                   level_codes=codes_mid, chain_codes=None, schedule=schedule,
                   tolerance=tolerance, max_epochs=max_epochs, leaf_recon=recon_m.copy(),
                   leaf_truth=temp_mid[D])

    # PASS 3: the prune, decided by the midpoint channel, code 3 set in both
    err_ok = np.abs(mid.leaf_recon - mid.leaf_truth.astype(np.int32)) < tolerance
    pruned = (codes_mid[D] == 0) & err_ok
    for d in range(D, -1, -1):
        if d < D:
            pruned = (codes_mid[d] == 0) & pruned[0::2] & pruned[1::2]
        codes_mid[d] = np.where(pruned, 3, codes_mid[d]).astype(np.uint8)
        codes_rng[d] = np.where(pruned, 3, codes_rng[d]).astype(np.uint8)

    # PASS 4: chain growth, driven by the midpoint's error; each step encodes
    # both channels of the leaves still growing
    n = mid.num_leaves
    max_chain = K.MAX_ADD_LEVELS
    chains_m = np.full((n, max_chain), K.NO_NODE, dtype=np.uint8)
    chains_r = np.full((n, max_chain), K.NO_NODE, dtype=np.uint8)
    rm = mid.leaf_recon.astype(np.int32)
    rr = recon_r.astype(np.int32)
    tm = mid.leaf_truth.astype(np.int32)
    tr = temp_rng[D].astype(np.int32)
    leaf_code = codes_mid[D]
    active = (leaf_code != 3) & (np.abs(rm - tm) > tolerance)
    needs_terminal = (leaf_code != 3) & ~active
    chains_m[needs_terminal, 0] = 3
    chains_r[needs_terminal, 0] = 3
    zero_start = np.full(n, -1, dtype=np.int32)  # where a trailing zero run starts

    pos = 0
    while pos < max_chain and active.any():
        depth = D + 1 + pos
        cm, new_rm, _ = K.encode_level(tm[active], rm[active], int(dm_mid[depth]))
        cr, new_rr, _ = K.encode_level(tr[active], rr[active], int(dm_rng[depth]))
        rm[active] = new_rm
        rr[active] = new_rr
        chains_m[active, pos] = cm
        chains_r[active, pos] = cr
        act_idx = np.nonzero(active)[0]
        zs = zero_start[act_idx]
        zero_start[act_idx] = np.where(cm == 0, np.where(zs == -1, pos, zs), -1)
        still = np.abs(rm - tm)[act_idx] > tolerance
        if pos + 1 < max_chain:
            chains_m[act_idx[~still], pos + 1] = 3
            chains_r[act_idx[~still], pos + 1] = 3
        active[:] = False
        active[act_idx[still]] = True
        pos += 1

    # a trailing run of midpoint code 0 becomes 3 in both channels: one
    # masked pass per chain column (the JAX package walks it leaf by leaf)
    idx = np.nonzero(zero_start >= 0)[0]
    if idx.size:
        sub_m, sub_r = chains_m[idx], chains_r[idx]
        zs = zero_start[idx]
        running = np.ones(idx.size, dtype=bool)
        for j in range(max_chain):
            at = running & (j >= zs)
            zero = at & (sub_m[:, j] == 0)
            sub_m[zero, j] = 3
            sub_r[zero, j] = 3
            running &= ~(at & ~zero)
        chains_m[idx], chains_r[idx] = sub_m, sub_r

    mid.chain_codes = chains_m
    mid.leaf_recon = rm
    mid.num_active_nodes = K._count_active(mid)
    return MidRangeTree(mid=mid, range_distance_map=dm_rng, range_level_codes=codes_rng,
                        range_chain_codes=chains_r, leaf_recon_range=rr, leaf_truth_range=tr)


def _range_view(tree: MidRangeTree) -> K.KdTree:
    """A ``KdTree`` view of the range channel on the midpoint's structure."""
    return dataclasses.replace(tree.mid, distance_map=tree.range_distance_map,
                               level_codes=tree.range_level_codes,
                               chain_codes=tree.range_chain_codes)


def level_cut(tree: MidRangeTree, cut_depth: int | None = None) -> np.ndarray:
    """The reference's ``levelCut``: the midpoint channel's level cut,
    (Z, Y, X) uint8."""
    return K.level_cut(tree.mid, cut_depth)


def level_cut_range(tree: MidRangeTree, cut_depth: int | None = None) -> np.ndarray:
    """The range channel's level cut, (Z, Y, X) uint8 (beyond the
    reference, whose shader-side consumer was never finished)."""
    return K.level_cut(_range_view(tree), cut_depth)


def to_device_pair(tree: MidRangeTree, device: torch.device | str = "cuda"):
    """Both channels on ``device`` for ``codecs/device.py``'s decode (they
    share one structure, so one spec): (midpoint tensors, range tensors,
    spec)."""
    from .device import to_device

    mid_dev, spec = to_device(tree.mid, device)
    rng_dev, _ = to_device(_range_view(tree), device)
    return mid_dev, rng_dev, spec


def to_preorder_pair(tree: MidRangeTree) -> tuple[np.ndarray, np.ndarray]:
    """Both channels' preorder streams; their positions agree by
    construction (one structure)."""
    return K.to_preorder(tree.mid), K.to_preorder(_range_view(tree))


def save(tree: MidRangeTree, path: str) -> None:
    """The dual-tree reference format (``MidRangeTree.cpp:753-786``): the
    kd-tree's header, both distance maps, then both packed streams."""
    X, Y, Z = tree.mid.dims
    pre_m, pre_r = to_preorder_pair(tree)
    with open(path, "wb") as f:
        f.write(K.FILE_HEADER.pack(0, 0, 0, X, Y, Z, tree.mid.max_depth, tree.mid.orig_depth,
                                   X, Y, Z, len(pre_m)))
        f.write(np.asarray(tree.mid.distance_map, dtype=np.uint8).tobytes())
        f.write(np.asarray(tree.range_distance_map, dtype=np.uint8).tobytes())
        f.write(pack2_np(pre_m).tobytes())
        f.write(pack2_np(pre_r).tobytes())


def open_tree(path: str) -> dict:
    """Read a dual-tree file's fields (both streams unpacked).  A file
    shorter than its header says raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < K.FILE_HEADER.size:
        raise ValueError(f"{path}: {len(data)} bytes, shorter than the header")
    fields = K.FILE_HEADER.unpack_from(data)
    max_depth, orig_depth = fields[6], fields[7]
    X, Y, Z, num_active = fields[8:12]
    off = K.FILE_HEADER.size
    nbytes = (num_active + 3) // 4
    if len(data) < off + 2 * (max_depth + 1) + 2 * nbytes:
        raise ValueError(f"{path}: {len(data)} bytes, shorter than its {num_active} codes need")
    dm_m = np.frombuffer(data, np.uint8, max_depth + 1, off)
    off += max_depth + 1
    dm_r = np.frombuffer(data, np.uint8, max_depth + 1, off)
    off += max_depth + 1
    pre_m = unpack2_np(np.frombuffer(data, np.uint8, nbytes, off), num_active)
    pre_r = unpack2_np(np.frombuffer(data, np.uint8, nbytes, off + nbytes), num_active)
    return dict(dims=(X, Y, Z), max_depth=max_depth, orig_depth=orig_depth,
                num_active_nodes=num_active, distance_map=np.array(dm_m),
                range_distance_map=np.array(dm_r), preorder=pre_m, range_preorder=pre_r)


def convert_to_byte_array(tree: MidRangeTree) -> np.ndarray:
    """The interleaved layout for a texture upload (``convertToByteArray``,
    ``MidRangeTree.cpp:1095-1128``): byte i = ``mid[2i] << 6 | range[2i] <<
    4 | mid[2i+1] << 2 | range[2i+1]``, zero-padded to a power of two
    bytes."""
    pre_m, pre_r = to_preorder_pair(tree)
    n = len(pre_m)
    nbytes = (n + 1) // 2
    v = 1 << max(0, int(np.ceil(np.log2(max(nbytes, 1)))))
    m = np.zeros(2 * v, dtype=np.uint8)
    r = np.zeros(2 * v, dtype=np.uint8)
    m[:n] = pre_m
    r[:n] = pre_r
    return ((m[0::2] << 6) | (r[0::2] << 4) | (m[1::2] << 2) | r[1::2]).astype(np.uint8)
