"""Brick-sharded rendering, in plain PyTorch: the volume split over a 3-D mesh.

Counterpart of ``volumerenderer_tpu/parallel/bricks.py`` (``make_brick_mesh``,
``shard_volume``, ``composite_segments_ordered``, ``render_bricksharded``).
The volume lives split over a mesh with axes ("bz", "by", "bx"): each device
holds one brick of the global (Z, Y, X) tensor.  ``ShardedVolume`` stands in
for a ``NamedSharding`` array: the mesh, the bricks on their devices and the
global shape.

Rendering: every shard marches the full ray set but samples only where the
trilinear anchor cell lies in its brick.  A one-voxel halo on each + face
(the next brick's first plane, copied to this brick's device; corners come
along because the slabs already extended along z are exchanged along y,
then x; the last brick of an axis repeats its own last plane, the clamp at
the volume's face) makes each owned sample the global trilinear value.  A
ray crosses a brick's anchor box in one interval of steps (the box is
convex), so each brick's owned samples form one segment of the compositing
recurrence (``parallel/context.py``), and the segments compose per ray in
the order of their first owned step.

Exactness: equal to the single-device march without the a > 0.99 early-out,
as the z-sharded path.  Positions are the JAX function's analytic
``entry + (t + 1)*step`` (``parallel/context.py``).

Over several processes (a mesh from ``multihost.global_mesh``) each process
holds and marches only the bricks of its own mesh entries: ``shard_volume``
takes the whole volume or this process's part of it (with its offset, the
counterpart of ``jax.make_array_from_process_local_data``; the bricks of
``host_local_bricks_3d``), the halo planes a brick needs from another
process come through ``multihost.gather``, and so do the segment maps, in
mesh order, before they fold.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.bricks import BrickGrid
from ..ops.raycast import ALPHA_SCALE, BIG_T, MAX_SAMPLES, apply_reference_transfer, step_sizes
from ..ops.sampling import gather_trilerp, rebased_taps, texel_coords
from . import multihost
from .sharding import DeviceMesh, default_devices

__all__ = ["make_brick_mesh", "ShardedVolume", "shard_volume", "host_local_bricks_3d",
           "extend_halos", "composite_segments_ordered", "render_bricksharded", "BIG_T"]


def make_brick_mesh(shape=(2, 2, 2), devices=None) -> DeviceMesh:
    """A 3-D mesh with axes ("bz", "by", "bx") over prod(shape) devices
    (default: round-robin over the host's CUDA cards)."""
    n = int(np.prod(shape))
    devices = default_devices(n) if devices is None else list(devices)[:n]
    if len(devices) != n:
        raise ValueError(f"a {tuple(shape)} brick mesh needs {n} devices, got {len(devices)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = d
    return DeviceMesh(grid.reshape(tuple(shape)), ("bz", "by", "bx"))


def volume_grid(mesh: DeviceMesh) -> tuple[int, int, int]:
    """How many shards a mesh splits (Z, Y, X) into: a 1-D mesh splits z
    (``parallel/context.py::make_z_mesh``), a ("bz", "by", "bx") mesh all
    three axes."""
    if mesh.devices.ndim == 1:
        return mesh.size, 1, 1
    if mesh.axis_names != ("bz", "by", "bx"):
        raise ValueError(f"expected a 1-D mesh or one with axes ('bz', 'by', 'bx'), got "
                         f"{mesh.axis_names}")
    return tuple(int(n) for n in mesh.devices.shape)


@dataclasses.dataclass
class ShardedVolume:
    """A (Z, Y, X) volume split over a mesh: ``bricks`` is an object array of
    shape ``volume_grid(mesh)`` whose entry (iz, iy, ix) is the brick
    [iz*Sz, (iz+1)*Sz) x [iy*Sy, ...) x [ix*Sx, ...) on its mesh device,
    or None where another process owns that entry."""

    mesh: DeviceMesh
    bricks: np.ndarray
    shape: tuple[int, int, int]

    @property
    def brick_shape(self) -> tuple[int, int, int]:
        return tuple(s // n for s, n in zip(self.shape, self.bricks.shape))


def shard_volume(mesh: DeviceMesh, volume: torch.Tensor, offset=None) -> ShardedVolume:
    """Split a (Z, Y, X) volume over the mesh (``volume_grid`` gives the
    split), each of this process's bricks copied to its device; the bricks
    of other processes' entries stay None.

    ``offset`` = (z, y, x): ``volume`` is this process's part of the global
    volume, starting at that voxel: the box of its own entries' bricks, as
    ``multihost.load_bricks_for_host`` or the bricks of
    :func:`host_local_bricks_3d` assemble it.  The global shape follows from
    the mesh.  Without it, ``volume`` is the global volume."""
    grid = volume_grid(mesh)
    local = [np.unravel_index(i, grid) for i in mesh.local_indices()]
    vshape = tuple(int(s) for s in volume.shape)
    if len(vshape) != 3:
        raise ValueError(f"volume {vshape} is not (Z, Y, X)")
    if offset is None:
        shape, origin = vshape, (0, 0, 0)
        if any(s % n for s, n in zip(shape, grid)):
            raise ValueError(f"volume {shape} does not split into {grid} bricks")
    else:
        lo = [int(min(idx[a] for idx in local)) for a in range(3)]
        span = [int(max(idx[a] for idx in local)) + 1 - lo[a] for a in range(3)]
        if len(local) != int(np.prod(span)) or any(s % n for s, n in zip(vshape, span)):
            raise ValueError(f"this process's entries {[tuple(map(int, i)) for i in local]} "
                             f"of a {grid} split do not tile its volume part {vshape}")
        brick = [s // n for s, n in zip(vshape, span)]
        origin = tuple(int(o) for o in offset)
        if origin != tuple(b * l for b, l in zip(brick, lo)):
            raise ValueError(f"offset {origin}: this process's part starts at "
                             f"{tuple(b * l for b, l in zip(brick, lo))}")
        shape = tuple(b * n for b, n in zip(brick, grid))
    Sz, Sy, Sx = (s // n for s, n in zip(shape, grid))
    devices = mesh.devices.reshape(grid)
    bricks = np.empty(grid, dtype=object)
    for iz, iy, ix in local:
        z, y, x = iz * Sz - origin[0], iy * Sy - origin[1], ix * Sx - origin[2]
        brick = volume[z:z + Sz, y:y + Sy, x:x + Sx]
        bricks[iz, iy, ix] = brick.to(devices[iz, iy, ix]).contiguous()
    return ShardedVolume(mesh, bricks, shape)


def host_local_bricks_3d(grid: BrickGrid, mesh_shape, shard_index) -> list[int]:
    """Brick file numbers intersecting one mesh shard's sub-volume: per-host
    brick I/O for the brick-sharded layout (each process reads only the
    files backing its own shards).  ``mesh_shape`` = (nbz, nby, nbx);
    ``shard_index`` = (iz, iy, ix)."""
    bx, by, bz = grid.brick_dims
    I, J, Kb = grid.grid
    X, Y, Z = I * bx, J * by, Kb * bz
    nbz, nby, nbx = mesh_shape
    iz, iy, ix = shard_index
    if Z % nbz or Y % nby or X % nbx:
        raise ValueError(f"a volume of (X, Y, Z) = {(X, Y, Z)} does not split into "
                         f"{tuple(mesh_shape)} shards")
    z_lo, z_hi = iz * Z // nbz, (iz + 1) * Z // nbz
    y_lo, y_hi = iy * Y // nby, (iy + 1) * Y // nby
    x_lo, x_hi = ix * X // nbx, (ix + 1) * X // nbx
    out = []
    for b in range(grid.num_bricks()):
        i, j, k = grid.brick_coords(b)
        if (k * bz < z_hi and (k + 1) * bz > z_lo
                and j * by < y_hi and (j + 1) * by > y_lo
                and i * bx < x_hi and (i + 1) * bx > x_lo):
            out.append(b)
    return out


def as_sharded(mesh: DeviceMesh, volume) -> ShardedVolume:
    """``volume`` as placed on ``mesh``: a ``ShardedVolume`` of that mesh as
    it is, a tensor split by :func:`shard_volume`."""
    if isinstance(volume, ShardedVolume):
        grid = volume_grid(mesh)
        if volume.bricks.shape != grid:
            raise ValueError(f"the volume is split {volume.bricks.shape}, the mesh {grid}")
        devices = mesh.devices.reshape(grid)
        local = [np.unravel_index(i, grid) for i in mesh.local_indices()]
        if any(volume.bricks[idx] is None or volume.bricks[idx].device != devices[idx]
               for idx in local):
            raise ValueError("the volume's bricks do not lie on the mesh's devices: "
                             "place it with shard_volume on this mesh")
        return volume
    return shard_volume(mesh, volume)


def extend_halos(bricks: np.ndarray, axes=(0, 1, 2), mesh: DeviceMesh | None = None
                 ) -> np.ndarray:
    """Append one halo plane to every brick along each of ``axes`` in turn:
    the next brick's first plane, copied to this brick's device; the last
    brick of an axis repeats its own last plane (the clamp at the volume's
    face).  Exchanging bricks already extended along earlier axes carries
    the edge and corner halos.  ``bricks`` is an object array of tensors,
    as ``ShardedVolume.bricks``; a new array of extended tensors is
    returned.  With a ``mesh`` over several processes (its flat order that
    of ``bricks``), each process extends its own bricks (the others are
    None), and the first planes of every brick come through
    ``multihost.gather`` for the neighbours that lie on another process."""
    out = bricks
    for axis in axes:
        n = out.shape[axis]
        firsts = None
        if mesh is not None and mesh.multiprocess:
            planes = multihost.gather(mesh, [(out.flat[i].narrow(axis, 0, 1).contiguous(),)
                                             for i in mesh.local_indices()])
            firsts = np.empty(out.size, dtype=object)
            for i, (plane,) in enumerate(planes):
                firsts[i] = plane
            firsts = firsts.reshape(out.shape)
        ext = np.empty(out.shape, dtype=object)
        for idx in np.ndindex(*out.shape):
            brick = out[idx]
            if brick is None:
                continue
            if idx[axis] == n - 1:
                halo = brick.narrow(axis, brick.shape[axis] - 1, 1)
            else:
                nxt = list(idx)
                nxt[axis] += 1
                nxt = tuple(nxt)
                src = out[nxt] if out[nxt] is not None else firsts[nxt]
                halo = src.narrow(axis, 0, 1).to(brick.device)
            ext[idx] = torch.cat([brick, halo], dim=axis)
        out = ext
    return out


def _sample_local3(ext, pos, lo, owned_shape, dims):
    """Trilinear sample from a halo-extended brick; ``owned`` marks positions
    whose anchor cell (clamped global floor index) lies in this brick."""
    X, Y, Z = dims
    Sz, Sy, Sx = owned_shape
    lz, ly, lx = lo
    Ez, Ey, Ex = ext.shape
    i0, frac = texel_coords(pos, dims)
    x0, y0, z0 = (torch.clamp(i0[..., a], 0, n - 1) for a, n in enumerate(dims))
    owned = ((z0 >= lz) & (z0 < lz + Sz) & (y0 >= ly) & (y0 < ly + Sy)
             & (x0 >= lx) & (x0 < lx + Sx))
    s = gather_trilerp(ext.reshape(-1), rebased_taps(i0[..., 0], X, lx, Ex, 1),
                       rebased_taps(i0[..., 1], Y, ly, Ey, Ex),
                       rebased_taps(i0[..., 2], Z, lz, Ez, Ex * Ey), frac)
    return s, owned


def composite_segments_ordered(C_all, T_all, t_first):
    """Fold (N, ...) segment maps per ray in traversal order (ascending
    ``t_first``; a segment that owns no sample carries ``BIG_T`` and is an
    identity map, so its place does not matter).  Returns (color, alpha)."""
    order = torch.argsort(t_first, dim=0, stable=True)
    Cs = torch.gather(C_all, 0, order)
    Ts = torch.gather(T_all, 0, order)
    c = torch.zeros_like(C_all[0])
    tau = torch.ones_like(T_all[0])
    for i in range(C_all.shape[0]):
        c, tau = c + tau * Cs[i], tau * Ts[i]
    return c, 1.0 - tau


def _brick_march(ext, entry_uv, direction, hit, lo, owned_shape, dims, max_samples):
    step = direction * step_sizes(dims, direction.device)
    C = torch.zeros(entry_uv.shape[:-1], dtype=torch.float32, device=entry_uv.device)
    T = torch.ones_like(C)
    tf = torch.full_like(C, BIG_T)
    for t in range(max_samples):
        pos = entry_uv + (float(t) + 1.0) * step
        inside = ((pos > 0.0) & (pos < 1.0)).all(dim=-1)
        s, owned = _sample_local3(ext, pos, lo, owned_shape, dims)
        m = hit & inside & owned
        C = torch.where(m, C + T * s * s, C)
        T = torch.where(m, T * (1.0 - ALPHA_SCALE * s), T)
        tf = torch.where(m, torch.clamp(tf, max=float(t)), tf)
    return C, T, tf


def render_bricksharded(mesh: DeviceMesh, volume, entry_uv, direction, hit,
                        max_samples: int = MAX_SAMPLES):
    """Render with the volume brick-sharded over ``mesh`` (axes ("bz", "by",
    "bx")).  ``volume`` is a (Z, Y, X) float32 tensor or a ``ShardedVolume``
    placed by :func:`shard_volume`.  Each of this process's bricks marches
    on its device; the segments gather in mesh order (on the mesh's first
    device in one process, on every process over several) and fold there.
    Returns (rgb, alpha) equal to the unsharded plain renderer without early
    termination."""
    sv = as_sharded(mesh, volume)
    Z, Y, X = sv.shape
    Sz, Sy, Sx = sv.brick_shape
    ext = extend_halos(sv.bricks, mesh=mesh)
    local = []
    for i in mesh.local_indices():
        idx = np.unravel_index(i, ext.shape)
        e = ext[idx]
        dev = e.device
        lo = (idx[0] * Sz, idx[1] * Sy, idx[2] * Sx)
        local.append(_brick_march(e, entry_uv.to(dev), direction.to(dev), hit.to(dev), lo,
                                  (Sz, Sy, Sx), (X, Y, Z), max_samples))
    C_all, T_all, tf_all = (torch.stack(f) for f in zip(*multihost.gather(mesh, local)))
    color, alpha = composite_segments_ordered(C_all, T_all, tf_all)
    return apply_reference_transfer(color, alpha), alpha
