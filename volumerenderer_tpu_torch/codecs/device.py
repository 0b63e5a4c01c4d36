"""The compressed tree on a device, and its level-cut decode there.

Counterpart of ``volumerenderer_tpu/codecs/device.py``: the 2-bit code
streams live on the device in packed uint8 words, and a level cut decodes
with shift/mask unpacking and a level-by-level clamped-Δ accumulation, plain
torch operations on the tree's device.  The JAX module's ``jit`` has no
counterpart: these run eagerly.

Deep trees (``orig_depth >= CHUNKED_DECODE_MIN_DEPTH``, e.g. the 256³ tree
at depth 24) decode per depth-K subtree chunk of 2^CHUNK_LEAF_BITS leaves,
as the JAX package does.  The JAX package maps over the chunks one at a
time (``lax.map``); here the chunks go in groups of consecutive ones, each
group's codes one contiguous run of every deeper level, so a 256³ decode
takes one pass and a 2048×2048×512 one 128 passes, while no intermediate
exceeds 2^CHUNK_GROUP_LEAF_BITS leaves.  Each decode is one ``vr.kd.decode``
span.

:func:`volume_leaf_order` is the inverse placement, the volume in
breadth-first leaf order chunk by chunk, which the device build starts
from; :func:`to_device` packs a tree's code arrays where they lie (the
device build's on the card), one row chunk of the chains at a time.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.bitarray import pack2, unpack2
from ..utils.timer import span
from .kdtree import NO_NODE, KdTree, _leaf_axes_perm

__all__ = ["DeviceKdTree", "to_device", "level_cut_device", "tree_occupancy_mip8",
           "volume_leaf_order", "CHUNKED_DECODE_MIN_DEPTH", "CHUNK_LEAF_BITS",
           "LEAF_ORDER_CHUNK_BITS"]

CHUNKED_DECODE_MIN_DEPTH = 21   # use the flat decode below this depth
CHUNK_LEAF_BITS = 16            # per-chunk leaf-array size (2^bits)
CHUNK_GROUP_LEAF_BITS = 24      # leaves decoded together by a group of chunks
LEAF_ORDER_CHUNK_BITS = 24      # leaves put in order by one copy (a CUDA copy takes 25 dims)
PACK_ROWS = 1 << 24             # chain rows packed at a time on a device


class DeviceKdTree(NamedTuple):
    """The compressed tree as tensors on one device."""

    packed_levels: tuple        # level d -> uint8 [ceil(2^d / 4)] packed codes
    packed_chains: torch.Tensor  # uint8 (num_leaves, ceil(chain_len / 4))
    distance_map: torch.Tensor   # int32 (max_depth + 1,)


def to_device(tree: KdTree, device: torch.device | str = "cuda") -> tuple[DeviceKdTree, dict]:
    """Put a tree on ``device``; returns (tensors, static spec for the
    decoder: dims, orig_depth, max_depth, schedule, chain_len).  The code
    arrays are packed where they lie, a host tree's on the host and a tree
    built on the card (``device_build.build_device``) there, so it never
    visits the host, and the packed bytes moved to ``device``."""
    chains = (torch.full((tree.num_leaves, 8), NO_NODE, dtype=torch.uint8)
              if tree.chain_codes is None else torch.as_tensor(tree.chain_codes))
    # NO_NODE packs to code 3, which the decode treats as terminal, so chains
    # pad with 3 and pack 4 codes per byte like the levels
    chain_len = -(-chains.shape[1] // 4) * 4
    dtree = DeviceKdTree(
        packed_levels=tuple(_pack_level(torch.as_tensor(c).to(torch.uint8)).to(device)
                            for c in tree.level_codes),
        packed_chains=_pack_chains(chains, chain_len).to(device),
        distance_map=torch.from_numpy(np.asarray(tree.distance_map).astype(np.int32)).to(device))
    spec = dict(dims=tuple(tree.dims), orig_depth=tree.orig_depth, max_depth=tree.max_depth,
                schedule=tuple(tree.schedule), chain_len=chain_len)
    return dtree, spec


def _pack_level(codes: torch.Tensor) -> torch.Tensor:
    """A level's codes packed 4 to a byte on their device: zero codes pad to
    a multiple of 4."""
    pad = (-codes.shape[0]) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    return pack2(codes)


def _pack_chains(chains: torch.Tensor, chain_len: int) -> torch.Tensor:
    """The chains packed on their device, ``PACK_ROWS`` rows at a time:
    NO_NODE -> 3, padded with 3 to ``chain_len`` codes a row, packed 4
    codes a byte."""
    n, m = chains.shape
    out = torch.empty((n, chain_len // 4), dtype=torch.uint8, device=chains.device)
    for r0 in range(0, n, PACK_ROWS):
        rows = chains[r0:r0 + PACK_ROWS]
        rows = torch.where(rows == NO_NODE, 3, rows).to(torch.uint8)
        if chain_len > m:
            rows = torch.cat([rows, rows.new_full((rows.shape[0], chain_len - m), 3)], dim=1)
        out[r0:r0 + PACK_ROWS] = pack2(rows)
    return out


def _step(scalars, frozen, codes, delta):
    """One level: clamp(scalar ± Δ) by code, unless frozen; code 3 freezes."""
    s = torch.where(codes == 1, torch.clamp(scalars + delta, max=255),
                    torch.where(codes == 2, torch.clamp(scalars - delta, min=0), scalars))
    return torch.where(frozen, scalars, s), frozen | (codes == 3)


def _codes_run(packed: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Codes [start, start + n) of a packed level, as int32."""
    b0, b1 = start // 4, -(-(start + n) // 4)
    return unpack2(packed[b0:b1])[start - 4 * b0:start - 4 * b0 + n].to(torch.int32)


def _top_levels(dtree: DeviceKdTree, K: int, cut_depth: int):
    """Scalars and frozen flags of the 2^K nodes at depth K."""
    root_codes = unpack2(dtree.packed_levels[0])[:1]
    scalars = dtree.distance_map[:1].clone()
    frozen = root_codes == 3
    for d in range(1, K + 1):
        scalars = scalars.repeat_interleave(2)
        frozen = frozen.repeat_interleave(2)
        if d > cut_depth:
            continue
        codes = _codes_run(dtree.packed_levels[d], 0, 1 << d)
        scalars, frozen = _step(scalars, frozen, codes, dtree.distance_map[d])
    return scalars, frozen


def _descend(dtree: DeviceKdTree, spec_key, cut_depth: int, K: int, scalars, frozen,
             first: int):
    """Leaf scalars (int32, breadth-first) under the consecutive depth-K
    nodes ``first .. first + len(scalars) - 1``, whose states are given."""
    dims, orig_depth, max_depth, schedule, chain_len = spec_key
    g = scalars.shape[0]
    dm = dtree.distance_map
    for d in range(K + 1, orig_depth + 1):
        scalars = scalars.repeat_interleave(2)
        frozen = frozen.repeat_interleave(2)
        if d > cut_depth:
            continue
        n = 1 << (d - K)
        codes = _codes_run(dtree.packed_levels[d], first * n, g * n)
        scalars, frozen = _step(scalars, frozen, codes, dm[d])
    if cut_depth > orig_depth and chain_len:
        L = 1 << (orig_depth - K)
        rows = dtree.packed_chains[first * L:(first + g) * L]
        chain_codes = unpack2(rows).to(torch.int32)
        for i in range(min(chain_len, cut_depth - orig_depth)):
            scalars, frozen = _step(scalars, frozen, chain_codes[:, i],
                                    dm[orig_depth + 1 + i])
    return scalars


def _decode_leaf_scalars(dtree: DeviceKdTree, spec_key, cut_depth: int) -> torch.Tensor:
    """Flat decode to per-leaf scalars (int32, breadth-first leaf order,
    length 2^orig_depth), shared by the volume decode and the mip8 grid."""
    scalars, frozen = _top_levels(dtree, 0, cut_depth)
    return _descend(dtree, spec_key, cut_depth, 0, scalars, frozen, 0)


def _leaves_to_volume(scalars: torch.Tensor, dims, schedule) -> torch.Tensor:
    X, Y, Z = dims
    perm, (nz, ny, nx) = _leaf_axes_perm(X, Y, Z, list(schedule))
    inv = [int(i) for i in np.argsort(perm)]
    return scalars.to(torch.uint8).reshape((2,) * (nz + ny + nx)).permute(inv).reshape(Z, Y, X)


def volume_leaf_order(vol: torch.Tensor, schedule, chunk_bits: int | None = None
                      ) -> torch.Tensor:
    """A (Z, Y, X) volume as a flat tensor in breadth-first leaf order
    (``kdtree.volume_to_leaves``), on its device: the first K = D −
    ``chunk_bits`` splits fix the top bits of each coordinate, so chunk c is
    a (bZ, bY, bX) box of the volume and a contiguous run of the leaves,
    ordered by the last D − K splits; each box goes in order by one copy of
    at most ``chunk_bits`` dims (default ``LEAF_ORDER_CHUNK_BITS``)."""
    Z, Y, X = vol.shape
    sched = list(schedule)
    D = len(sched)
    K = max(0, D - (LEAF_ORDER_CHUNK_BITS if chunk_bits is None else chunk_bits))
    pfx = sched[:K]
    gX, gY, gZ = 1 << pfx.count(0), 1 << pfx.count(1), 1 << pfx.count(2)
    bX, bY, bZ = X // gX, Y // gY, Z // gZ
    perm_T, (tz, ty, tx) = _leaf_axes_perm(bX, bY, bZ, sched[K:])
    n = 1 << (D - K)
    out = torch.empty(1 << D, dtype=vol.dtype, device=vol.device)
    grid = vol.reshape(gZ, bZ, gY, bY, gX, bX)
    for c in range(1 << K):
        g = [0, 0, 0]  # chunk c's (x, y, z) grid index: c's bits, MSB first, by pfx's axes
        for i, axis in enumerate(pfx):
            g[axis] = (g[axis] << 1) | ((c >> (K - 1 - i)) & 1)
        box = grid[g[2], :, g[1], :, g[0], :].reshape((2,) * (tz + ty + tx))
        out[c * n:(c + 1) * n] = box.permute(perm_T).reshape(-1)
    return out


def _level_cut_impl(dtree: DeviceKdTree, spec_key, cut_depth: int) -> torch.Tensor:
    dims, _, _, schedule, _ = spec_key
    return _leaves_to_volume(_decode_leaf_scalars(dtree, spec_key, cut_depth), dims, schedule)


def _level_cut_chunked_impl(dtree: DeviceKdTree, spec_key, cut_depth: int, K: int) -> torch.Tensor:
    """Decode per depth-K subtree: the first K splits fix the top bits of each
    coordinate, so chunk c is a contiguous (bZ, bY, bX) box of the output and
    a contiguous run of every deeper level's codes."""
    dims, orig_depth, max_depth, schedule, chain_len = spec_key
    scalars, frozen = _top_levels(dtree, K, cut_depth)

    def group(c0, g):
        return _descend(dtree, spec_key, cut_depth, K, scalars[c0:c0 + g], frozen[c0:c0 + g], c0)

    return _place_chunks(dims, schedule, K, group, scalars.device)


def _place_chunks(dims, schedule, K: int, decode_group, device,
                  group_leaf_bits: int | None = None) -> torch.Tensor:
    """The (Z, Y, X) uint8 volume from its depth-K chunks: ``decode_group(c0,
    g)`` gives the leaf scalars of chunks c0 .. c0 + g − 1 in breadth-first
    leaf order, g chunks holding up to 2^group_leaf_bits leaves (default
    ``CHUNK_GROUP_LEAF_BITS``); each chunk is a (bZ, bY, bX) box, put in
    place by tensors of at most D − K + 1 dims.  Shared with the hashed
    codec's decode."""
    if group_leaf_bits is None:
        group_leaf_bits = CHUNK_GROUP_LEAF_BITS
    X, Y, Z = dims
    sched = list(schedule)
    orig_depth = len(sched)
    pfx, tfx = sched[:K], sched[K:]
    gX, gY, gZ = 1 << pfx.count(0), 1 << pfx.count(1), 1 << pfx.count(2)
    bX, bY, bZ = X // gX, Y // gY, Z // gZ
    C = 1 << K
    perm_T, _ = _leaf_axes_perm(bX, bY, bZ, tfx)
    inv_T = [1 + int(i) for i in np.argsort(perm_T)]
    group = 1 << max(0, group_leaf_bits - (orig_depth - K))
    boxes = torch.empty((C, bZ, bY, bX), dtype=torch.uint8, device=device)
    for c0 in range(0, C, group):
        g = min(group, C - c0)
        s = decode_group(c0, g)
        box = s.to(torch.uint8).reshape((g,) + (2,) * (orig_depth - K)).permute([0] + inv_T)
        boxes[c0:c0 + g] = box.reshape(g, bZ, bY, bX)
    # chunk index -> (gz, gy, gx) grid position (breadth-first over pfx)
    perm_P, _ = _leaf_axes_perm(gX, gY, gZ, pfx)
    inv_P = [int(i) for i in np.argsort(perm_P)]
    grid = boxes.reshape((2,) * K + (bZ, bY, bX)).permute(inv_P + [K, K + 1, K + 2])
    grid = grid.reshape(gZ, gY, gX, bZ, bY, bX)
    return grid.permute(0, 3, 1, 4, 2, 5).reshape(Z, Y, X)


def _spec_key(spec: dict):
    return (tuple(spec["dims"]), spec["orig_depth"], spec["max_depth"],
            tuple(spec["schedule"]), spec["chain_len"])


def level_cut_device(dtree: DeviceKdTree, spec: dict, cut_depth: int | None = None,
                     chunk_bits: int | None = None) -> torch.Tensor:
    """Decode a level cut on the tree's device; returns (Z, Y, X) uint8.

    Trees with ``orig_depth >= CHUNKED_DECODE_MIN_DEPTH`` decode per chunk of
    2^CHUNK_LEAF_BITS leaves; ``chunk_bits`` forces a chunk of
    2^chunk_bits leaves at any depth (tests)."""
    if cut_depth is None:
        cut_depth = spec["max_depth"]
    D = spec["orig_depth"]
    bits = chunk_bits if chunk_bits is not None else (
        CHUNK_LEAF_BITS if D >= CHUNKED_DECODE_MIN_DEPTH else None)
    with span("vr.kd.decode"):
        if bits is not None and D - 1 > bits:
            return _level_cut_chunked_impl(dtree, _spec_key(spec), int(cut_depth), D - bits)
        return _level_cut_impl(dtree, _spec_key(spec), int(cut_depth))


def _tree_mip8_impl(dtree: DeviceKdTree, spec_key, cut_depth: int) -> torch.Tensor:
    """Per-8³-block maxima from the tree's leaf scalars: the max over each
    axis's last min(3, log2(dim)) splits.  The decoded cut is piecewise
    constant on cut-depth node boxes, so this is exactly the block max of
    the decoded volume."""
    dims, orig_depth, max_depth, schedule, chain_len = spec_key
    X, Y, Z = dims
    sched = list(schedule)
    with span("vr.kd.decode"):
        scalars = _decode_leaf_scalars(dtree, spec_key, cut_depth)
    need = {0: min(3, int(np.log2(X))), 1: min(3, int(np.log2(Y))), 2: min(3, int(np.log2(Z)))}
    chosen: list[int] = []
    for a in (0, 1, 2):
        occ = [i for i, sd in enumerate(sched) if sd == a]
        chosen.extend(occ[len(occ) - need[a]:])
    D = len(sched)
    m = scalars.reshape((2,) * D)
    if chosen:
        m = m.amax(dim=tuple(sorted(chosen)))
    m = m.reshape(-1)  # breadth-first over the reduced schedule
    reduced = [sd for i, sd in enumerate(sched) if i not in set(chosen)]
    gX, gY, gZ = X >> need[0], Y >> need[1], Z >> need[2]  # the 8-block grid
    perm, (nz, ny, nx) = _leaf_axes_perm(gX, gY, gZ, reduced)
    inv = [int(i) for i in np.argsort(perm)]
    g = m.reshape((2,) * (nz + ny + nx)).permute(inv).reshape(gZ, gY, gX)
    return g.to(torch.float32)


def _mip8_of_cut(vol_u8: torch.Tensor) -> torch.Tensor:
    """``block_max8`` of a decoded (Z, Y, X) uint8 cut, in 0..255 units."""
    from ..ops.cuda.raycast_kernel import block_max8

    return block_max8(vol_u8)


def tree_occupancy_mip8(dtree: DeviceKdTree, spec: dict,
                        cut_depth: int | None = None) -> torch.Tensor:
    """Per-8³-block maxima of the decoded level cut, (ceil(Z/8), ceil(Y/8),
    ceil(X/8)) float32 in 0..255 units, as ``block_max8`` gives them.
    Shallow trees reduce the tree's own leaf scalars (no dense pass); deep
    trees (the chunked-decode regime) take the block max of the chunked
    decode, the same array by definition at a transient Z*Y*X bytes."""
    if cut_depth is None:
        cut_depth = spec["max_depth"]
    if spec["orig_depth"] >= CHUNKED_DECODE_MIN_DEPTH:
        return _mip8_of_cut(level_cut_device(dtree, spec, int(cut_depth)))
    return _tree_mip8_impl(dtree, _spec_key(spec), int(cut_depth))
