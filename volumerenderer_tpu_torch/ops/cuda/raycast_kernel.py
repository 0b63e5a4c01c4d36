"""Compositing march on the GPU: the launch wrapper of
``csrc/composite_march.cu`` and the plan-once / render-many API.

Counterpart of ``volumerenderer_tpu/ops/pallas/raycast_kernel.py``
(``CompositingPlan``, ``render_compositing_pallas``).  The TPU plan's
prepasses (footprint scan, DMA word tables, ray packing into lane tiles, the
window-height cost model) only feed the TPU kernel's DMA windows; the CUDA
kernel reads the volume straight from device memory, so a plan here is the
ray tensors on the device plus the per-step increment.  ``render`` is one
launch, as the TPU launch is: B1 (``composite_march_cuda``) reads the
float32 volume, quantizing each tap to 8 bits as it reads it (or a uint8
volume's bytes), and writes the displayed image in its epilogue.

``CompositingPlan.bind`` is the exact empty-space skip of B1, B6 and B7 (a
``BlockBound``: the block grid of ``ops/blockgrid.py``, shared with the
isosurface bind through ``blockgrid_kernel.bind_grid``, in place of the TPU
plan's occupancy word tables); the TPU grids ``expand_mip`` and
``occupancy_mip`` are ported as plain torch functions, and no kernel reads
them.

The compressed-domain render state lives here too: ``build_slab_pool``
(pair16 words) and ``build_slab_pool_narrow`` (f32 pair values) keep only the
z-slabs of the volume that can be sampled, deduplicated by content, and the
pooled marches (B6 on the narrow pool, B7 on the pair16 pool) read only the
pool, through the slab map (``CompositingPlan.render_pooled``).

Every wrapper dispatches on where its tensors lie: CUDA tensors launch the
kernel, CPU tensors run the plain PyTorch version
(``ops/raycast.py::composite_march_steps``, with
``ops/sampling.py::slab_pool_sampler`` for the pooled marches, and the
reference transfer).  There is no fallback from one to the other: a CUDA
input the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.timer import span
from ..blockgrid import BlockBound, check_bound
from ..raycast import MAX_SAMPLES, apply_reference_transfer, composite_march_steps, step_sizes
from ..sampling import WRAP_MODES, as_normalized_volume, slab_pool_sampler
from . import _build
from ._launch import (SLAB_H, bind, check_clamp, check_hit, check_image, check_max_samples,
                      check_shape, check_tensors, check_volume, count_launch, dense_entry, launch,
                      pool_dims, ptr)
from .blockgrid_kernel import bind_grid

__all__ = ["composite_march_cuda", "composite_march_pooled_narrow_cuda",
           "composite_march_pooled_pair16_cuda", "quantize_u8", "CompositingPlan",
           "render_compositing_kernel", "load_kernel", "block_max8", "expand_mip",
           "occupancy_mip", "pack_pairs", "pack_pairs16", "build_slab_pool",
           "build_slab_pool_narrow", "pool_dims", "SLAB_H"]


def load_kernel() -> _build.BuiltLibrary:
    """Build (at first use) and load the march kernel's library (B1, B6, B7)."""
    return _dense_launcher("composite_march")[1]


@functools.cache
def _dense_launcher(entry: str):
    # entry_uv, dir_step, hit, vol, grid; H, W, X, Y, Z, max_samples, repeat;
    # out, alpha, stream
    return bind("composite_march", 5, 7, [ctypes.c_void_p] * 3, entry=entry)


def _skipping(bound):
    """``bound`` where its grid holds a block to skip, else None: on a field
    with data everywhere the skip test would only cost."""
    return bound if bound is not None and bound.has_empty else None


def composite_march_cuda(volume: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                         hit: torch.Tensor, max_samples: int = MAX_SAMPLES,
                         wrap: str = "clamp", bound: BlockBound | None = None):
    """March an (H, W) ray image through the volume's 8-bit grid (B1) and
    write the displayed image in the kernel's epilogue.

    Args:
      volume: (Z, Y, X) volume, x fastest: uint8, read as its bytes, or
        float32, whose taps the kernel quantizes to 8 bits as it reads them
        (the result is the byte route's on ``quantize_u8(volume)``, bit for
        bit, with no quantize pass and no byte copy); any other dtype
        raises ValueError.
      entry_uv: (H, W, 3) float32 cube entry points in texture space.
      dir_step: (H, W, 3) float32 per-step increment (direction / dims).
      hit: (H, W) uint8, nonzero where the ray enters the cube.
      wrap: "clamp" (clamp-to-edge) or "repeat" (GL_REPEAT).
      bound: None, or a compositing ``BlockBound`` of this volume made for
        ``wrap`` (``CompositingPlan.bind``): samples in blocks that read
        only zero bytes are skipped, the result is the same bit for bit.  A
        bound for other dims or another wrap raises ValueError; that it
        describes this volume, the caller answers for
        (``CompositingPlan.render`` checks it).

    Returns (rgb (H, W, 3), alpha (H, W)) float32, rgb bit for bit
    ``apply_reference_transfer(color, alpha)``.  CUDA tensors run the kernel
    and add one to ``composite_march_cuda.launches`` (and, for a float32
    volume, to its ``f32_launches``); CPU tensors run the plain version on
    ``quantize_u8(volume)``.
    """
    tensors = {"volume": volume, "entry_uv": entry_uv, "dir_step": dir_step, "hit": hit}
    check_tensors(tensors, "volume")
    entry = dense_entry("composite_march", volume)
    check_volume(volume, volume.dtype, "volume")
    check_hit(hit)
    check_image(tensors, hit.shape, torch.float32, ("entry_uv", "dir_step"), (3,))
    check_max_samples(max_samples)
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")
    Z, Y, X = volume.shape
    grid = check_bound(bound, (X, Y, Z), wrap, device=volume.device)
    if volume.device.type == "cpu":
        color, alpha = composite_march_steps(as_normalized_volume(quantize_u8(volume)), entry_uv,
                                             dir_step, hit.to(torch.bool), max_samples, wrap,
                                             early_exit=True, bound=bound)
        return apply_reference_transfer(color, alpha), alpha
    H, W = hit.shape
    rgb = torch.empty((H, W, 3), dtype=torch.float32, device=volume.device)
    alpha = torch.empty((H, W), dtype=torch.float32, device=volume.device)
    if H * W == 0:
        return rgb, alpha
    launch(lambda: _dense_launcher(entry), "composite_march", volume.device,
           entry_uv.data_ptr(), dir_step.data_ptr(), hit.data_ptr(), volume.data_ptr(),
           ptr(grid), H, W, X, Y, Z, max_samples, int(wrap == "repeat"), rgb.data_ptr(),
           alpha.data_ptr())
    count_launch(composite_march_cuda, volume)
    return rgb, alpha


composite_march_cuda.launches = 0
composite_march_cuda.f32_launches = 0


def quantize_u8(volume: torch.Tensor) -> torch.Tensor:
    """The 8-bit grid the marches sample (the TPU kernel's too): a float32
    volume in [0, 1] -> uint8 ``round(clamp(v, 0, 1) * 255)``, exact for
    volumes made by ``as_normalized_volume`` from bytes; a uint8 volume is
    its own bytes and is returned as it is.  Any other dtype raises."""
    if volume.dtype == torch.uint8:
        return volume
    if volume.dtype != torch.float32:
        raise ValueError(f"the volume must be float32 in [0, 1] or uint8, got {volume.dtype}")
    return torch.round(torch.clamp(volume, 0.0, 1.0) * 255.0).to(torch.uint8)


def init_plan(plan, entry_uv: torch.Tensor, direction: torch.Tensor, hit: torch.Tensor, dims,
              max_samples: int, wrap: str) -> torch.Tensor:
    """Set what both plans keep of a ray bundle: ``dims`` (X, Y, Z),
    ``max_samples``, ``wrap``, ``shape`` (H, W) and, on the rays' device,
    ``entry_uv`` float32, ``dir_step = direction * (1/X, 1/Y, 1/Z)`` and
    ``hit`` as uint8.  Returns the float32 direction."""
    plan.dims = tuple(int(d) for d in dims)
    if len(plan.dims) != 3:
        raise ValueError(f"dims must be (X, Y, Z), got {dims!r}")
    plan.max_samples = int(max_samples)
    plan.wrap = wrap
    H, W, _ = entry_uv.shape
    plan.shape = (H, W)
    plan.entry_uv = entry_uv.to(torch.float32).contiguous()
    direction = direction.to(torch.float32).contiguous()
    plan.dir_step = (direction * step_sizes(plan.dims, direction.device)).contiguous()
    plan.hit = hit.to(torch.uint8).contiguous()
    return direction


class CompositingPlan:
    """Plan-once / render-many compositing for a fixed ray bundle.

    Keeps the rays on their device (``init_plan``).  ``render`` runs the
    CUDA kernel when the rays lie on a CUDA device and the plain PyTorch
    march when they lie on the CPU.  ``bind`` is the exact empty-space skip:
    one ``BlockBound`` (the dims, the wrap, the block grid of a volume or a
    slab pool, in place of the TPU plan's occupancy word tables, and that
    data's identity) that ``render`` and ``render_pooled`` take and check
    against their data.  ``seg_starts`` keeps the segment marches' entry
    tables of these rays by (owned box, max_samples, device), built at first
    use by the volume-sharded renders (``parallel/kernel_sharded.py``): 16
    bytes per ray and shard, more than the 25 the rays take, so
    ``seg_starts.clear()`` frees them where a camera will not be seen again.
    """

    def __init__(self, entry_uv: torch.Tensor, direction: torch.Tensor, hit: torch.Tensor,
                 dims, max_samples: int = MAX_SAMPLES, wrap: str = "clamp"):
        init_plan(self, entry_uv, direction, hit, dims, max_samples, wrap)
        self.seg_starts = {}

    def rows(self, start: int, stop: int, device=None) -> "CompositingPlan":
        """The plan of image rows [start, stop), on ``device`` (default: this
        plan's): its ray tensors sliced, and copied when the device differs.
        Each ray marches alone, so the rows render as they do in the whole
        plan, bit for bit."""
        sub = object.__new__(CompositingPlan)
        sub.dims, sub.max_samples, sub.wrap = self.dims, self.max_samples, self.wrap
        sub.shape = (stop - start, self.shape[1])
        sub.seg_starts = {}
        for name in ("entry_uv", "dir_step", "hit"):
            t = getattr(self, name)[start:stop]
            setattr(sub, name, t if device is None else t.to(device))
        return sub

    def check_volume(self, volume: torch.Tensor) -> None:
        """Raise ValueError unless ``volume`` has the plan's (Z, Y, X) shape."""
        check_shape(volume, self.dims)

    def bind(self, volume: torch.Tensor | None = None, mip8: torch.Tensor | None = None,
             pool=None) -> BlockBound:
        """The exact empty-space skip of this plan's marches (the port of the
        JAX plan's ``bind``, through ``blockgrid_kernel.bind_grid``): a
        ``BlockBound`` holding the dims, the wrap, the block grid and the
        identity of the data it describes, exactly one of ``volume`` ((Z,
        Y, X) float32 in [0, 1] or uint8, the tensor later passed to
        :meth:`render`) and ``pool`` (a ``(pool, slab_map)`` pair, later
        passed to :meth:`render_pooled`; clamp only).  The grid comes from
        that data's bytes, or, given ``mip8`` (per-8^3-block maxima of the
        same data, e.g. ``codecs/device.tree_occupancy_mip8``), from the
        mip, with no pass over the data: the compositing skip needs only
        each block's largest byte, and the mip's grid (a block's maximum
        with its upper neighbours', which covers the footprint) skips a
        subset of the samples the exact grid skips.

        A zero sample composites as a no-op, so the bound render equals the
        unbound one bit for bit.  Pass the bound with the same data: a bound
        made for other dims or another wrap, or from another tensor (or one
        written in place since), raises ValueError there, and an
        inference-mode tensor (no version counter) raises here.  The grid
        depends only on the data and the wrap: one bound serves every plan
        of the same dims and wrap, and ``bind_grid`` keeps the grid and
        ``has_empty`` while the data lives, so a bind of the same tensor,
        unwritten since, builds nothing (writes torch's version counter does
        not see, through ``.data``, numpy or DLPack views or raw pointers,
        are not seen here either).  Where the grid holds no empty block (a
        field with data everywhere) the bound has nothing to skip, and
        :meth:`render` marches without it: the skip test would cost every
        sample (``has_empty``)."""
        return bind_grid(self.dims, self.wrap, self.hit.device, volume, pool, mip8)

    def render(self, volume: torch.Tensor, bound: BlockBound | None = None):
        """volume: (Z, Y, X) on the plan's device, float32 in [0, 1] or
        uint8.  One launch of B1 marches it and writes the displayed image
        (the reference transfer in its epilogue): it quantizes a float32
        volume's taps to 8 bits as it reads them (no quantize pass; bit for
        bit the march on ``quantize_u8(volume)``) and reads a uint8 volume's
        bytes.  Any other dtype raises.  A view (a slice of a larger volume)
        is copied first, as the kernel reads the volume in place.
        ``bound``: None, or :meth:`bind`'s result from this very volume
        tensor (the march skips exactly; the image is the same).  Returns
        (rgb (H, W, 3), alpha (H, W)).  The call is one ``vr.composite.render``
        span."""
        with span("vr.composite.render"):
            self.check_volume(volume)
            check_bound(bound, self.dims, self.wrap, data=(volume,))
            volume = volume.contiguous()
            return composite_march_cuda(volume, self.entry_uv, self.dir_step, self.hit,
                                        self.max_samples, self.wrap, _skipping(bound))

    def render_pooled(self, pool: torch.Tensor, slab_map: torch.Tensor,
                      bound: BlockBound | None = None):
        """Compressed-domain render from a slab pool on the plan's device:
        the pool's dtype picks the kernel, B7 for an int32 pair16 pool
        (``build_slab_pool``), B6 for a float32 narrow pool
        (``build_slab_pool_narrow``).  Equal bit for bit to :meth:`render`
        of the volume the pool was built from.  Clamp-only: a plan with
        ``wrap="repeat"`` raises.  ``bound``: None, or :meth:`bind`'s result
        from this very pool and slab map (``bind(pool=(pool, slab_map))``).
        The kernel writes the displayed image, as for :meth:`render`.
        Returns (rgb (H, W, 3), alpha (H, W)).  The call is one
        ``vr.composite.render_pooled`` span."""
        with span("vr.composite.render_pooled"):
            dims = pool_dims(pool, slab_map)
            if dims != self.dims:
                raise ValueError(f"the pool holds a volume of (X, Y, Z) = {dims}, the plan's "
                                 f"is {self.dims}")
            check_bound(bound, dims, self.wrap, data=(pool, slab_map))
            march = (composite_march_pooled_pair16_cuda if pool.dtype == torch.int32
                     else composite_march_pooled_narrow_cuda)
            return march(pool, slab_map, self.entry_uv, self.dir_step, self.hit,
                         self.max_samples, self.wrap, _skipping(bound))


def _byte_values(volume: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) volume -> its 8-bit samples as float32 0..255: uint8 as it
    is, a float volume as ``round(clamp(v, 0, 1) * 255)`` (the JAX package's
    quantization)."""
    if volume.dim() != 3:
        raise ValueError(f"expected a (Z, Y, X) volume, got shape {tuple(volume.shape)}")
    if volume.dtype == torch.uint8:
        return volume.to(torch.float32)
    return torch.round(torch.clamp(volume.to(torch.float32), 0.0, 1.0) * 255.0)


def block_max8(volume: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) uint8 or float volume in [0, 1] -> (ceil(Z/8), ceil(Y/8),
    ceil(X/8)) float32 per-8³-block maxima in 0..255 units (counterpart of
    ``volumerenderer_tpu/ops/pallas/raycast_kernel.py::block_max8``).
    ``codecs/device.py::tree_occupancy_mip8`` gives the same grid from the
    tree."""
    # a byte volume's maxima are taken on its bytes (a float32 copy would be
    # four times its size), the same numbers
    s = volume if volume.dtype == torch.uint8 and volume.dim() == 3 else _byte_values(volume)
    Z, Y, X = s.shape
    s = F.pad(s, (0, (-X) % 8, 0, (-Y) % 8, 0, (-Z) % 8))
    Zp, Yp, Xp = s.shape
    return s.reshape(Zp // 8, 8, Yp // 8, 8, Xp // 8, 8).amax(dim=(1, 3, 5)).to(torch.float32)


def expand_mip(m8: torch.Tensor, reach_x: int = 3, reach_z: int = 2) -> torch.Tensor:
    """Forward-max expansion of the 8^3 block grid (counterpart of
    ``volumerenderer_tpu/ops/pallas/raycast_kernel.py::expand_mip``): cell
    (i, j, k) covers z in [8i, 8i + 8*reach_z), y in [8j, 8j + 16), x in
    [8k, 8k + 8*reach_x), the last cell of each axis repeated past the
    edge.  The TPU plan bounds a whole DMA window's footprint with one
    gather of it; the CUDA marches look up each sample's own anchor block
    in the tight per-anchor grid (``ops/blockgrid.py``) instead, so no
    kernel reads this grid."""

    def fwd_max(m, axis, reach):
        out = m
        n = m.shape[axis]
        for r in range(1, reach):
            shifted = torch.cat([m.narrow(axis, min(r, n), n - min(r, n)),
                                 m.narrow(axis, n - 1, 1).repeat_interleave(min(r, n), dim=axis)],
                                dim=axis)
            out = torch.maximum(out, shifted)
        return out

    m8 = fwd_max(m8, 0, reach_z)
    m8 = fwd_max(m8, 1, 2)
    return fwd_max(m8, 2, reach_x)


def occupancy_mip(volume: torch.Tensor, reach_x: int = 3) -> torch.Tensor:
    """The TPU plan's conservative per-window bound from a dense volume
    (counterpart of the JAX function of that name): cell (i, j, k) is the
    largest 8-bit sample over z in [8i, 8i + 16), y in [8j, 8j + 16), x in
    [8k, 8k + 8*reach_x), i.e. ``expand_mip(block_max8(volume), reach_x)``.
    As for :func:`expand_mip`, the GPU skip uses the per-anchor grid in its
    place."""
    return expand_mip(block_max8(volume), reach_x)


def pack_pairs(volume: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) uint8 or float volume -> float32 pair volume ``s[x]*256 +
    s[x+1]`` of the 8-bit samples, x + 1 clamped to the edge."""
    s = _byte_values(volume)
    return s * 256.0 + torch.cat([s[:, :, 1:], s[:, :, -1:]], dim=2)


PACK_VOXELS = 1 << 26  # voxels pack_pairs16 packs at a time


def pack_pairs16(volume: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) uint8 or float volume -> (Z, Y, X // 2) int32 holding two
    16-bit pairs per word, ``word[k] = pair16[2k] | pair16[2k+1] << 16`` with
    ``pair16[x] = s[x]*256 + s[x+1]`` (x + 1 clamped).  Requires X even."""
    if volume.dim() != 3 or volume.shape[2] % 2:
        raise ValueError(f"pair16 packing needs a (Z, Y, X) volume with X even, got "
                         f"{tuple(volume.shape)}")
    Z, Y, X = volume.shape
    out = torch.empty((Z, Y, X // 2), dtype=torch.int32, device=volume.device)
    rows = max(1, PACK_VOXELS // max(1, Y * X))  # z rows a pass packs
    for z0 in range(0, Z, rows):
        p16 = pack_pairs(volume[z0:z0 + rows]).to(torch.int32)
        lo, hi = p16[:, :, 0::2], p16[:, :, 1::2]
        # hi << 16 as a signed word, without overflowing int32
        out[z0:z0 + rows] = torch.where(hi >= 32768, hi - 65536, hi) * 65536 | lo
    return out



def _occupied_slabs(volume: torch.Tensor, mip8) -> np.ndarray:
    """Which z-slabs the pool keeps: slab b spans z-blocks b and b + 1, so it
    is occupied when either has a nonzero block max.  ``mip8`` (e.g.
    ``codecs/device.py::tree_occupancy_mip8``) or else ``block_max8`` of the
    volume decides."""
    Z = volume.shape[0]
    m8 = block_max8(volume) if mip8 is None else torch.as_tensor(mip8)
    zocc = (m8 > 0).reshape(m8.shape[0], -1).any(dim=1).cpu().numpy()
    n_slabs = Z // 8
    occ = zocc[:n_slabs].copy()
    occ[:-1] |= zocc[1:n_slabs]
    return occ


def _slab_pool(packed: torch.Tensor, occ: np.ndarray):
    """Pool and slab map from a packed (Z, Y, W) volume: slot 0 all zero,
    then the distinct occupied slabs in first-seen order (deduplicated by
    their words: a slab whose word sum equals a kept slab's is compared with
    it whole, on the device), each 16 rows from z = 8b (zero rows past
    Z)."""
    Z, Y, W = packed.shape
    dev = packed.device
    occ_idx = [int(b) for b in np.nonzero(occ)[0]]

    def slab(b: int) -> torch.Tensor:
        rows = packed[8 * b:8 * b + SLAB_H]
        if rows.shape[0] < SLAB_H:
            rows = torch.cat([rows, packed.new_zeros((SLAB_H - rows.shape[0], Y, W))])
        return rows

    sums = (torch.stack([torch.sum(slab(b), dtype=torch.int64) for b in occ_idx]).tolist()
            if occ_idx else [])
    slots = np.zeros(Z // 8, np.int32)
    by_sum: dict[int, list] = {}
    keep: list[int] = []
    for b, total in zip(occ_idx, sums):
        slot = next((k for k in by_sum.get(total, ())
                     if torch.equal(slab(b), slab(keep[k - 1]))), None)
        if slot is None:
            keep.append(b)
            slot = len(keep)
            by_sum.setdefault(total, []).append(slot)
        slots[b] = slot
    pool = packed.new_empty((1 + len(keep), SLAB_H, Y, W))
    pool[0].zero_()
    for k, b in enumerate(keep):
        pool[1 + k] = slab(b)
    return pool, torch.from_numpy(slots[None, :]).to(dev)


def build_slab_pool(volume: torch.Tensor, mip8=None):
    """Sparse z-slab residency of the volume as pair16 words, on the
    volume's device (counterpart of the JAX function of that name, with the
    same arrays).

    Returns ``(pool, slab_map)``: ``pool`` is (n_slots, 16, Y, X // 2) int32,
    slot 0 all zero (shared by every empty slab) and slot i >= 1 the z rows
    [8b, 8b + 16) of an occupied z-block b; ``slab_map`` is (1, Z // 8) int32
    with ``slab_map[0, b]`` the slot of z-block b.  A slab maps to slot 0
    only when its two z-blocks have block max 0, so every tap read there is
    truly 0.  Occupied slabs are deduplicated by content, in first-seen
    order.  ``volume`` is (Z, Y, X) uint8 or float in [0, 1], Z % 8 == 0 and
    X even; ``mip8`` is as ``block_max8`` gives it (``None``: computed from
    the volume)."""
    if volume.dim() != 3 or volume.shape[0] % 8 or volume.shape[2] % 2:
        raise ValueError(f"build_slab_pool needs a (Z, Y, X) volume with Z % 8 == 0 and X "
                         f"even, got {tuple(volume.shape)}")
    with span("vr.pool.build"):
        return _slab_pool(pack_pairs16(volume), _occupied_slabs(volume, mip8))


def build_slab_pool_narrow(volume: torch.Tensor, mip8=None):
    """As :func:`build_slab_pool`, with the f32 pair values ``s[x]*256 +
    s[x+1]`` in place of pair16 words: ``pool`` is (n_slots, 16, Y, X)
    float32, with the same slots and map.

    The JAX package's narrow pool also stores a copy shifted by 64 in x and
    cuts x into 128-lane chunks, both for its lane gathers; neither is kept,
    so this pool is its first X/128 chunks re-laid out, at half its bytes,
    and X % 128 is not required.  Z % 8 == 0."""
    if volume.dim() != 3 or volume.shape[0] % 8:
        raise ValueError(f"build_slab_pool_narrow needs a (Z, Y, X) volume with Z % 8 == 0, "
                         f"got {tuple(volume.shape)}")
    with span("vr.pool.build"):
        return _slab_pool(pack_pairs(volume), _occupied_slabs(volume, mip8))


@functools.cache
def _pooled_launcher(fmt: str):
    # entry_uv, dir_step, hit, pool, slab_map, grid; H, W, X, Y, Z, n_slots,
    # max_samples; out, alpha, stream
    return bind("composite_march", 6, 7, [ctypes.c_void_p] * 3,
                entry=f"composite_march_pooled_{fmt}")


def _composite_march_pooled(wrapper, fmt, pool, slab_map, entry_uv, dir_step, hit,
                            max_samples, wrap, bound):
    tensors = {"pool": pool, "slab_map": slab_map, "entry_uv": entry_uv,
               "dir_step": dir_step, "hit": hit}
    check_tensors(tensors, "pool")
    dims = pool_dims(pool, slab_map, fmt)
    check_hit(hit)
    check_image(tensors, hit.shape, torch.float32, ("entry_uv", "dir_step"), (3,))
    check_max_samples(max_samples)
    check_clamp(wrap, "the pooled marches")
    grid = check_bound(bound, dims, wrap, device=pool.device)
    if pool.device.type == "cpu":
        color, alpha = composite_march_steps(slab_pool_sampler(pool, slab_map, dims), entry_uv,
                                             dir_step, hit.to(torch.bool), max_samples,
                                             early_exit=True, bound=bound)
        return apply_reference_transfer(color, alpha), alpha
    H, W = hit.shape
    X, Y, Z = dims
    rgb = torch.empty((H, W, 3), dtype=torch.float32, device=pool.device)
    alpha = torch.empty((H, W), dtype=torch.float32, device=pool.device)
    if H * W == 0:
        return rgb, alpha
    launch(lambda: _pooled_launcher(fmt), "composite_march", pool.device,
           entry_uv.data_ptr(), dir_step.data_ptr(), hit.data_ptr(), pool.data_ptr(),
           slab_map.data_ptr(), ptr(grid), H, W, X, Y, Z, int(pool.shape[0]), max_samples,
           rgb.data_ptr(), alpha.data_ptr())
    wrapper.launches += 1
    return rgb, alpha


def composite_march_pooled_narrow_cuda(pool: torch.Tensor, slab_map: torch.Tensor,
                                       entry_uv: torch.Tensor, dir_step: torch.Tensor,
                                       hit: torch.Tensor, max_samples: int = MAX_SAMPLES,
                                       wrap: str = "clamp", bound: BlockBound | None = None):
    """B6: :func:`composite_march_cuda`'s march, sampling the narrow f32
    slab pool (``build_slab_pool_narrow``) through its slab map.  Equal bit
    for bit to the dense march on the volume the pool was built from.
    ``wrap`` must be "clamp"; ``bound``, as for
    :func:`composite_march_cuda`, describes this pool
    (``CompositingPlan.render_pooled`` checks that it was bound from it).
    Returns (rgb (H, W, 3), alpha (H, W)) as the dense march does.  CUDA
    tensors run the kernel and add one to
    ``composite_march_pooled_narrow_cuda.launches``; CPU tensors run the
    plain version."""
    return _composite_march_pooled(composite_march_pooled_narrow_cuda, "narrow", pool,
                                   slab_map, entry_uv, dir_step, hit, max_samples, wrap, bound)


composite_march_pooled_narrow_cuda.launches = 0


def composite_march_pooled_pair16_cuda(pool: torch.Tensor, slab_map: torch.Tensor,
                                       entry_uv: torch.Tensor, dir_step: torch.Tensor,
                                       hit: torch.Tensor, max_samples: int = MAX_SAMPLES,
                                       wrap: str = "clamp", bound: BlockBound | None = None):
    """B7: as :func:`composite_march_pooled_narrow_cuda`, on the pair16 pool
    (``build_slab_pool``); adds one to
    ``composite_march_pooled_pair16_cuda.launches`` per kernel launch."""
    return _composite_march_pooled(composite_march_pooled_pair16_cuda, "pair16", pool,
                                   slab_map, entry_uv, dir_step, hit, max_samples, wrap, bound)


composite_march_pooled_pair16_cuda.launches = 0


def render_compositing_kernel(volume, entry_uv, direction, hit,
                              max_samples: int = MAX_SAMPLES, wrap: str = "clamp"):
    """Drop-in replacement for ``render_compositing`` through the march
    kernel (both wrap modes); the volume (float32 in [0, 1] or uint8) is
    sampled on its 8-bit grid."""
    Z, Y, X = volume.shape
    plan = CompositingPlan(entry_uv, direction, hit, (X, Y, Z), max_samples, wrap)
    return plan.render(volume)
