"""The benchmark's plain reference of the progressive kd-tree codec
(AugmentariumLab/VolumeRenderer ``VolumeKdTree_recover.cpp``), in plain
PyTorch on the volume's device, a level (or a chunk of ``CHUNK`` nodes of a
level) at a time.  It imports nothing of the program.

* the split schedule: the cycle-and-skip rule of ``buildRecursive``
  (``:151-159``), power-of-two extents;
* the leaf order: leaf n's bits, MSB first, go to the split axes in
  schedule order, each axis's first split its top bit; a voxel's leaf index
  is the sum of one table per axis, so the volume goes to leaf order by one
  scatter a z-chunk, and back by one gather;
* the midrange pyramid (``:191-198``): a leaf's value its byte, an interior
  node's (min + max) // 2 over its leaves;
* per level, ``encodeNode`` (``:457-502``) in exact integers, ties none >
  add > sub, and the gradient descent on Δ (``:271-369``, with the two
  deviations the port documents: a per-evaluation error reset and a final
  encode at the chosen Δ), its own copy;
* each level's Δ seed, the upstream's sequential running mean
  (``:254-267,415-455``), one node after another in plain C
  (``seed_loop.c``, built with the host's compiler), on the host beside
  the build: the loop carries its mean from node to node, so it cannot be
  cut into torch passes, and a level's seed needs only its own truth and
  its parent level's recon.  So that the seeds of all levels can run at
  once, each level's Δ is fitted from the seed the program recorded; a level
  whose recorded seed differs from this one counts as a bad level, so where
  none does, every fit started from this reference's own seed;
* the prune (``:596-629``) and the chains on the Δ ladder 64..1 under the
  leaves beyond the tolerance, trailing zero runs made terminal
  (``:655-697``);
* the level cut (``levelCut``, ``:726-835``): the root's scalar is
  ``distanceMap[0]`` (the upstream's quirk), a child's clamp(parent ± Δ) by
  its code, frozen below code 3 and below the cut.

:func:`check_tree` compares the program's packed tree (2-bit codes, 4 to a
byte, LSB first; a chain row's absent nodes packed as 3) and its decoded cut
with this build's, code for code and voxel for voxel.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

MAX_ADD_LEVELS = 7
ADD_LEVEL_DISTANCES = (64, 32, 16, 8, 4, 2, 1)
GAMMA, STEP_H, MAX_ABS_STEP = 1.25, 1.0, 4.0
NO_NODE = 255
CHUNK = 1 << 26
SEED_THREADS = 4  # levels seeded at once on the host


def _chunks(n: int):
    for s in range(0, n, CHUNK):
        yield s, min(n, s + CHUNK)


def split_schedule(X: int, Y: int, Z: int) -> list:
    """Per depth the split axis (0 x, 1 y, 2 z): the depth's axis in turn,
    skipping an axis already cut to one cell."""
    ext = [X, Y, Z]
    for n in ext:
        if n <= 0 or n & (n - 1):
            raise ValueError(f"power-of-two extents only, got {ext}")
    schedule = []
    for depth in range(sum(int(n).bit_length() - 1 for n in ext)):
        axis, i = depth % 3, 0
        while ext[axis] == 1:
            i += 1
            axis = (depth + i) % 3
        schedule.append(axis)
        ext[axis] //= 2
    return schedule


def _index_tables(dims, schedule, device):
    """Per axis (x, y, z) the leaf-index part of each coordinate (int64)."""
    D = len(schedule)
    tables = []
    for axis, n in enumerate(dims):
        bits = int(n).bit_length() - 1
        c = torch.arange(n, dtype=torch.int64, device=device)
        part = torch.zeros(n, dtype=torch.int64, device=device)
        k = 0
        for i, a in enumerate(schedule):
            if a == axis:
                part |= ((c >> (bits - 1 - k)) & 1) << (D - 1 - i)
                k += 1
        tables.append(part)
    return tables


def _z_rows(Y: int, X: int) -> int:
    return max(1, CHUNK // (Y * X))


def to_leaves(vol: torch.Tensor, schedule) -> torch.Tensor:
    """(Z, Y, X) bytes -> the flat leaves in breadth-first order."""
    Z, Y, X = vol.shape
    fx, fy, fz = _index_tables((X, Y, Z), schedule, vol.device)
    leaves = torch.empty(Z * Y * X, dtype=vol.dtype, device=vol.device)
    rows = _z_rows(Y, X)
    for z0 in range(0, Z, rows):
        z1 = min(Z, z0 + rows)
        idx = fz[z0:z1, None, None] + fy[None, :, None] + fx[None, None, :]
        leaves[idx.reshape(-1)] = vol[z0:z1].reshape(-1)
    return leaves


def to_volume(leaves: torch.Tensor, dims, schedule) -> torch.Tensor:
    """The flat leaves -> the (Z, Y, X) volume."""
    X, Y, Z = dims
    fx, fy, fz = _index_tables((X, Y, Z), schedule, leaves.device)
    vol = torch.empty((Z, Y, X), dtype=leaves.dtype, device=leaves.device)
    rows = _z_rows(Y, X)
    for z0 in range(0, Z, rows):
        z1 = min(Z, z0 + rows)
        idx = fz[z0:z1, None, None] + fy[None, :, None] + fx[None, None, :]
        vol[z0:z1] = leaves[idx]
    return vol


def pyramid(leaves: torch.Tensor, D: int) -> list:
    levels = [None] * (D + 1)
    levels[D] = leaves
    lo = hi = leaves
    for d in range(D - 1, -1, -1):
        lo = torch.minimum(lo[0::2], lo[1::2])
        hi = torch.maximum(hi[0::2], hi[1::2])
        mid = torch.empty_like(lo)
        for s, e in _chunks(lo.shape[0]):
            mid[s:e] = ((lo[s:e].to(torch.int32) + hi[s:e].to(torch.int32)) // 2).to(torch.uint8)
        levels[d] = mid
    return levels


def encode(t: torch.Tensor, p: torch.Tensor, dist: int):
    """(codes uint8, recon int32, error int32) of nodes with truth ``t`` and
    parent estimate ``p`` (int32)."""
    none_err = (p - t).abs()
    add_est = torch.clamp(p + dist, max=255)
    sub_est = torch.clamp(p - dist, min=0)
    add_err = (add_est - t).abs()
    sub_err = (sub_est - t).abs()
    err = torch.minimum(torch.minimum(none_err, add_err), sub_err)
    codes = torch.where(none_err == err, 0, torch.where(add_err == err, 1, 2)).to(torch.uint8)
    recon = torch.where(codes == 0, p, torch.where(codes == 1, add_est, sub_est))
    return codes, recon, err


def _parent(recon_above: torch.Tensor, s: int, e: int) -> torch.Tensor:
    idx = torch.arange(s, e, device=recon_above.device) // 2
    return recon_above[idx].to(torch.int32)


@functools.cache
def _seed_loop():
    """``seed_loop.c``'s ``seed_level``, built with the host's C compiler
    (``$CC``, else ``cc`` or ``gcc``) in a temporary directory."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "seed_loop.c")
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc") or "cc"
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "seed_loop.so")
        subprocess.run([cc, "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-o", lib, src],
                       check=True)
        fn = ctypes.CDLL(lib).seed_level
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = None
    return fn


def seed_sums(truth: np.ndarray, parent: np.ndarray, shift: int) -> tuple:
    """The running mean's (sum, count) over a level of uint8 ``truth``,
    node i's parent estimate the uint8 ``parent[i >> shift]``."""
    t = np.ascontiguousarray(truth, dtype=np.uint8)
    p = np.ascontiguousarray(parent, dtype=np.uint8)
    if t.shape[0] and p.shape[0] <= (t.shape[0] - 1) >> shift:
        raise ValueError(f"{p.shape[0]} parent estimates for {t.shape[0]} nodes")
    out = np.zeros(2, dtype=np.float64)
    _seed_loop()(t.ctypes.data, p.ctypes.data, t.shape[0], shift, out.ctypes.data)
    return float(out[0]), float(out[1])


def seed_level(truth: np.ndarray, parent: np.ndarray, shift: int) -> float:
    """The level's Δ seed: round(sum / count), half away from zero, or 0."""
    s, c = seed_sums(truth, parent, shift)
    return float(np.floor(s / c + 0.5)) if c > 0 else 0.0


def fit_distance(mean_sq_err, max_epochs: int, seed: float) -> int:
    """The upstream's gradient descent on Δ, from ``seed``: central
    difference at Δ ± 1, step clamp(−1.25 · dE/dΔ, ±4), rounded; an error
    that grows reverts the step and halves it; stops on a repeat, an error
    under 1, a step under 0.5 or ``max_epochs``."""
    epoch, dist = 0, seed
    prev_dist, prev_step, prev_err = 0.0, 255.0, 65025.0
    err = df = step = 0.0
    while epoch < max_epochs and abs(prev_step) >= 0.5:
        if epoch != 0:
            prev_dist, prev_err, prev_df, prev_step = dist, err, df, step
            dist = float(np.floor(min(255.0, max(0.0, prev_dist + prev_step)) + 0.5))
            if dist == prev_dist:
                break
        err = mean_sq_err(int(dist))
        if err < 1.0:
            break
        if epoch != 0 and err > prev_err:
            err, dist, df, step = prev_err, prev_dist, prev_df, prev_step / 2.0
            epoch += 1
            continue
        lo = int(max(0.0, dist - STEP_H))
        hi = int(min(255.0, dist + STEP_H))
        df = (mean_sq_err(hi) - mean_sq_err(lo)) / (2.0 * STEP_H)
        step = max(-MAX_ABS_STEP, min(MAX_ABS_STEP, -GAMMA * df))
        epoch += 1
    return int(dist)


def build_levels(vol: torch.Tensor, max_epochs: int, seeds, pool):
    """(schedule, Δ per depth, each level's codes before the prune, the
    leaves' recon and truth, each level's own seed as a future of ``pool``)
    of a (Z, Y, X) uint8 volume, each level's Δ fitted from ``seeds[d]``."""
    Z, Y, X = vol.shape
    schedule = split_schedule(X, Y, Z)
    D = len(schedule)
    levels = pyramid(to_leaves(vol, schedule), D)
    dists, codes, own_seeds = [], [], []
    recon = torch.zeros(1, dtype=torch.uint8, device=vol.device)
    for d in range(D + 1):
        truth = levels[d]
        n = truth.shape[0]
        own_seeds.append(pool.submit(seed_level, truth.cpu().numpy(), recon.cpu().numpy(), 1))

        def sq_err(dist, truth=truth, recon=recon, n=n):
            total = 0
            for s, e in _chunks(n):
                _, _, err = encode(truth[s:e].to(torch.int32), _parent(recon, s, e), dist)
                total += int(torch.sum(err.to(torch.int64) ** 2))
            return total / n

        dist = fit_distance(sq_err, max_epochs, float(seeds[d]))
        c = torch.empty(n, dtype=torch.uint8, device=vol.device)
        r = torch.empty(n, dtype=torch.uint8, device=vol.device)
        for s, e in _chunks(n):
            cc, rr, _ = encode(truth[s:e].to(torch.int32), _parent(recon, s, e), dist)
            c[s:e], r[s:e] = cc, rr.to(torch.uint8)
        dists.append(dist)
        codes.append(c)
        recon = r
        if d < D:
            levels[d] = None
    return schedule, dists + list(ADD_LEVEL_DISTANCES), codes, recon, levels[D], own_seeds


def prune(codes: list, recon: torch.Tensor, truth: torch.Tensor, tolerance: int) -> None:
    D = len(codes) - 1
    ok = torch.empty(truth.shape, dtype=torch.bool, device=truth.device)
    for s, e in _chunks(truth.shape[0]):
        err = (recon[s:e].to(torch.int32) - truth[s:e].to(torch.int32)).abs()
        ok[s:e] = (codes[D][s:e] == 0) & (err < tolerance)
    codes[D].masked_fill_(ok, 3)
    for d in range(D - 1, -1, -1):
        ok = (codes[d] == 0) & ok[0::2] & ok[1::2]
        codes[d].masked_fill_(ok, 3)


def grow_chains(leaf_code, recon, truth, tolerance: int):
    """(chains (n, 7) uint8 with NO_NODE where there is no node) of a chunk
    of leaves."""
    n = leaf_code.shape[0]
    dev = leaf_code.device
    t = truth.to(torch.int32)
    r = recon.to(torch.int32)
    chains = torch.full((n, MAX_ADD_LEVELS), NO_NODE, dtype=torch.uint8, device=dev)
    growing = (leaf_code != 3) & ((r - t).abs() > tolerance)
    chains[(leaf_code != 3) & ~growing, 0] = 3
    for pos, dist in enumerate(ADD_LEVEL_DISTANCES):
        c, new_r, _ = encode(t, r, dist)
        chains[growing, pos] = c[growing]
        r = torch.where(growing, new_r, r)
        done = growing & ((r - t).abs() <= tolerance)
        if pos + 1 < MAX_ADD_LEVELS:
            chains[done, pos + 1] = 3
        growing = growing & ~done
    # a chain's trailing zeros (its eval nodes after its last nonzero code)
    # become 3
    body = (chains != NO_NODE) & (chains != 3)
    nonzero = body & (chains != 0)
    last = MAX_ADD_LEVELS - 1 - torch.flip(nonzero, [1]).to(torch.uint8).argmax(dim=1)
    last = torch.where(nonzero.any(dim=1), last, -1)
    col = torch.arange(MAX_ADD_LEVELS, device=dev)[None, :]
    chains[body & (chains == 0) & (col > last[:, None])] = 3
    return chains


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """Bytes (..., k) -> 2-bit codes (..., 4k), LSB first."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=packed.device)
    return ((packed[..., None] >> shifts) & 3).reshape(packed.shape[:-1] + (-1,))


def _step(s, frozen, code, delta: int):
    new = torch.where(code == 1, torch.clamp(s + delta, max=255),
                      torch.where(code == 2, torch.clamp(s - delta, min=0), s))
    return torch.where(frozen, s, new)


def check_tree(vol: torch.Tensor, tolerance: int, max_epochs: int, seeds, cut_depth: int,
               prog_dm, prog_levels, prog_chains, prog_cut):
    """This build of ``vol`` against the program's packed tree, its recorded
    seeds and its decoded cut.  Returns ({delta_bad_levels, code_bad,
    cut_bad_voxels}, this build's decoded cut).  A level is bad where its Δ
    or its recorded seed differs from this build's."""
    with ThreadPoolExecutor(SEED_THREADS) as pool:
        schedule, dists, codes, recon, truth, own_seeds = build_levels(vol, max_epochs, seeds,
                                                                       pool)
        D = len(codes) - 1
        prune(codes, recon, truth, tolerance)
        code_bad = 0
        for d, c in enumerate(codes):
            for a, b in _chunks(c.shape[0]):
                got = unpack(prog_levels[d][a // 4:(b + 3) // 4])[:b - a]
                code_bad += int((got != c[a:b]).sum())
        dm = [int(v) for v in dists]
        # the cut, level by level from the root's scalar distanceMap[0]
        s = torch.full((1,), dm[0], dtype=torch.uint8, device=vol.device)
        frozen = codes[0] == 3
        for d in range(1, D + 1):
            s, frozen = s.repeat_interleave(2), frozen.repeat_interleave(2)
            if d <= cut_depth:
                for a, b in _chunks(s.shape[0]):
                    code = codes[d][a:b]
                    s[a:b] = _step(s[a:b].to(torch.int32), frozen[a:b], code,
                                   dm[d]).to(torch.uint8)
                    frozen[a:b] |= code == 3
        for a, b in _chunks(truth.shape[0]):
            chains = grow_chains(codes[D][a:b], recon[a:b], truth[a:b], tolerance)
            got = unpack(prog_chains[a:b])[:, :MAX_ADD_LEVELS]
            code_bad += int((got != torch.where(chains == NO_NODE, 3, chains)).sum())
            leaf, f = s[a:b].to(torch.int32), frozen[a:b]
            for i in range(min(MAX_ADD_LEVELS, cut_depth - D)):
                code = chains[:, i]
                leaf = _step(leaf, f, code, dm[D + 1 + i])
                f = f | (code == 3) | (code == NO_NODE)
            s[a:b] = leaf.to(torch.uint8)
        cut = to_volume(s, (vol.shape[2], vol.shape[1], vol.shape[0]), schedule)
        cut_bad = float((cut != prog_cut).sum())
        own_seeds = [f.result() for f in own_seeds]
    prog_dm, seeds = [int(v) for v in prog_dm], [float(v) for v in seeds]
    bad = {d for d, (a, b) in enumerate(zip(dists, prog_dm)) if a != b}
    bad |= {d for d, (a, b) in enumerate(zip(own_seeds, seeds)) if a != b}
    bad_levels = len(bad) + abs(len(dists) - len(prog_dm)) + abs(len(own_seeds) - len(seeds))
    numbers = {"delta_bad_levels": float(bad_levels), "code_bad": float(code_bad),
               "cut_bad_voxels": cut_bad}
    return numbers, cut
