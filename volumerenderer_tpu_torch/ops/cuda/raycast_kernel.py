"""Compositing march on the GPU: the launch wrapper of
``csrc/composite_march.cu`` and the plan-once / render-many API.

Counterpart of ``volumerenderer_tpu/ops/pallas/raycast_kernel.py``
(``CompositingPlan``, ``render_compositing_pallas``).  The TPU plan's
prepasses (footprint scan, DMA word tables, ray packing into lane tiles, the
window-height cost model) only feed the TPU kernel's DMA windows; the CUDA
kernel reads the volume straight from device memory, so a plan here is the
ray tensors on the device plus the per-step increment.  ``render`` is one
launch, as the TPU launch is: B1 reads the float32 volume, quantizing each
tap to 8 bits as it reads it (``composite_march_f32_cuda``), and writes the
displayed image in its epilogue; ``composite_march_cuda`` is B1 on a byte
volume.

The compressed-domain render state lives here too: ``build_slab_pool``
(pair16 words) and ``build_slab_pool_narrow`` (f32 pair values) keep only the
z-slabs of the volume that can be sampled, deduplicated by content, and the
pooled marches (B6 on the narrow pool, B7 on the pair16 pool) read only the
pool, through the slab map (``CompositingPlan.render_pooled``).

Every wrapper dispatches on where its tensors lie: CUDA tensors launch the
kernel, CPU tensors run the plain PyTorch version
(``ops/raycast.py::composite_march_steps``, with
``ops/sampling.py::slab_pool_sampler`` for the pooled marches).  There is no
fallback from one to the other: a CUDA input the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..raycast import (MAX_SAMPLES, apply_reference_transfer, composite_march_steps,
                       step_sizes)
from ..sampling import WRAP_MODES, as_normalized_volume, slab_pool_sampler
from . import _build
from ._launch import (bind, check_clamp, check_hit, check_image, check_max_samples,
                      check_tensors, check_volume, launch)

__all__ = ["composite_march_cuda", "composite_march_f32_cuda",
           "composite_march_pooled_narrow_cuda", "composite_march_pooled_pair16_cuda",
           "quantize_u8", "CompositingPlan",
           "render_compositing_kernel", "load_kernel", "block_max8", "pack_pairs",
           "pack_pairs16", "build_slab_pool", "build_slab_pool_narrow", "pool_dims", "SLAB_H"]

_INT32_MAX = 2**31 - 1


def load_kernel() -> _build.BuiltLibrary:
    """Build (at first use) and load the march kernel's library (B1, B6, B7)."""
    return _dense_launcher("composite_march")[1]


@functools.cache
def _dense_launcher(entry: str):
    # entry_uv, dir_step, hit, vol; H, W, X, Y, Z, max_samples, repeat, rgb;
    # out, alpha, stream
    return bind("composite_march", 4, 8, [ctypes.c_void_p] * 3, entry=entry)


def _march_dense(wrapper, entry: str, dtype, volume, entry_uv, dir_step, hit, max_samples, wrap,
                 transfer: bool):
    name = "vol_u8" if dtype == torch.uint8 else "volume"
    tensors = {name: volume, "entry_uv": entry_uv, "dir_step": dir_step, "hit": hit}
    check_tensors(tensors, name)
    check_volume(volume, dtype, name)
    check_hit(hit)
    check_image(tensors, hit.shape, torch.float32, ("entry_uv", "dir_step"), (3,))
    check_max_samples(max_samples)
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")
    if volume.device.type == "cpu":
        vol_u8 = volume if dtype == torch.uint8 else quantize_u8(volume)
        color, alpha = composite_march_steps(as_normalized_volume(vol_u8), entry_uv, dir_step,
                                             hit.to(torch.bool), max_samples, wrap,
                                             early_exit=True)
        return (apply_reference_transfer(color, alpha) if transfer else color), alpha
    H, W = hit.shape
    Z, Y, X = volume.shape
    out = torch.empty((H, W, 3) if transfer else (H, W), dtype=torch.float32,
                      device=volume.device)
    alpha = torch.empty((H, W), dtype=torch.float32, device=volume.device)
    if H * W == 0:
        return out, alpha
    launch(lambda: _dense_launcher(entry), "composite_march", volume.device,
           entry_uv.data_ptr(), dir_step.data_ptr(), hit.data_ptr(), volume.data_ptr(), H, W,
           X, Y, Z, max_samples, int(wrap == "repeat"), int(transfer), out.data_ptr(),
           alpha.data_ptr())
    wrapper.launches += 1
    return out, alpha


def composite_march_cuda(vol_u8: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                         hit: torch.Tensor, max_samples: int = MAX_SAMPLES,
                         wrap: str = "clamp", transfer: bool = False):
    """March an (H, W) ray image through the 8-bit volume (B1).

    Args:
      vol_u8: (Z, Y, X) uint8 volume, x fastest.
      entry_uv: (H, W, 3) float32 cube entry points in texture space.
      dir_step: (H, W, 3) float32 per-step increment (direction / dims).
      hit: (H, W) uint8, nonzero where the ray enters the cube.
      wrap: "clamp" (clamp-to-edge) or "repeat" (GL_REPEAT).
      transfer: write the displayed image in the kernel's epilogue.

    Returns (color, alpha), each (H, W) float32; with ``transfer`` (rgb
    (H, W, 3), alpha), rgb bit for bit ``apply_reference_transfer(color,
    alpha)``.  CUDA tensors run the kernel and add one to
    ``composite_march_cuda.launches``; CPU tensors run the plain version.
    """
    return _march_dense(composite_march_cuda, "composite_march", torch.uint8, vol_u8, entry_uv,
                        dir_step, hit, max_samples, wrap, transfer)


composite_march_cuda.launches = 0


def composite_march_f32_cuda(volume: torch.Tensor, entry_uv: torch.Tensor,
                             dir_step: torch.Tensor, hit: torch.Tensor,
                             max_samples: int = MAX_SAMPLES, wrap: str = "clamp",
                             transfer: bool = False):
    """B1 on the (Z, Y, X) float32 volume: the kernel quantizes each tap to 8
    bits as it reads it, so the result is :func:`composite_march_cuda`'s on
    ``quantize_u8(volume)``, bit for bit, with no quantize pass and no byte
    copy.  The other arguments and the returns are
    :func:`composite_march_cuda`'s.  CUDA tensors run the kernel and add one
    to ``composite_march_f32_cuda.launches``; CPU tensors run the plain
    version on ``quantize_u8(volume)``."""
    return _march_dense(composite_march_f32_cuda, "composite_march_f32", torch.float32, volume,
                        entry_uv, dir_step, hit, max_samples, wrap, transfer)


composite_march_f32_cuda.launches = 0


def quantize_u8(volume: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) float32 in [0, 1] -> uint8 ``round(clamp(v, 0, 1) * 255)``,
    the 8-bit grid the TPU kernel samples too.  Exact for volumes made by
    ``as_normalized_volume`` from bytes."""
    return torch.round(torch.clamp(volume, 0.0, 1.0) * 255.0).to(torch.uint8)


def _dense_march_for(volume: torch.Tensor):
    """The dense march wrapper for ``volume``'s dtype: float32 ->
    :func:`composite_march_f32_cuda` (taps quantized as they are read),
    uint8 -> :func:`composite_march_cuda`; any other dtype raises."""
    marches = {torch.float32: composite_march_f32_cuda, torch.uint8: composite_march_cuda}
    if volume.dtype not in marches:
        raise ValueError(f"the volume must be float32 in [0, 1] or uint8, got {volume.dtype}")
    return marches[volume.dtype]


class CompositingPlan:
    """Plan-once / render-many compositing for a fixed ray bundle.

    Keeps the rays on their device: ``entry_uv`` float32, ``dir_step =
    direction * (1/X, 1/Y, 1/Z)`` and ``hit`` as uint8.  ``dims`` is
    (X, Y, Z).  ``render`` runs the CUDA kernel when the rays lie on a CUDA
    device and the plain PyTorch march when they lie on the CPU.
    ``seg_starts`` keeps the segment marches' entry tables of these rays by
    (owned box, max_samples, device), built at first use by the
    volume-sharded renders (``parallel/kernel_sharded.py``): 16 bytes per ray
    and shard, more than the 25 the rays take, so ``seg_starts.clear()``
    frees them where a camera will not be seen again.
    """

    def __init__(self, entry_uv: torch.Tensor, direction: torch.Tensor, hit: torch.Tensor,
                 dims, max_samples: int = MAX_SAMPLES, wrap: str = "clamp"):
        self.dims = tuple(int(d) for d in dims)
        if len(self.dims) != 3:
            raise ValueError(f"dims must be (X, Y, Z), got {dims!r}")
        self.max_samples = int(max_samples)
        self.wrap = wrap
        H, W, _ = entry_uv.shape
        self.shape = (H, W)
        self.entry_uv = entry_uv.to(torch.float32).contiguous()
        self.dir_step = (direction.to(torch.float32)
                         * step_sizes(self.dims, direction.device)).contiguous()
        self.hit = hit.to(torch.uint8).contiguous()
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
        X, Y, Z = self.dims
        if tuple(volume.shape) != (Z, Y, X):
            raise ValueError(f"volume shape {tuple(volume.shape)} does not match the "
                             f"plan's (Z, Y, X) = {(Z, Y, X)}")

    def render(self, volume: torch.Tensor):
        """volume: (Z, Y, X) on the plan's device, float32 in [0, 1] or
        uint8.  One launch of B1 marches it and writes the displayed image
        (the reference transfer in its epilogue): it quantizes a float32
        volume's taps to 8 bits as it reads them (no quantize pass; bit for
        bit the march on ``quantize_u8(volume)``) and reads a uint8 volume's
        bytes.  Any other dtype raises.  A view (a slice of a larger volume)
        is copied first, as the kernel reads the volume in place.  Returns
        (rgb (H, W, 3), alpha (H, W))."""
        self.check_volume(volume)
        volume = volume.contiguous()
        return _dense_march_for(volume)(volume, self.entry_uv, self.dir_step, self.hit,
                                        self.max_samples, self.wrap, transfer=True)

    def render_pooled(self, pool: torch.Tensor, slab_map: torch.Tensor):
        """Compressed-domain render from a slab pool on the plan's device:
        the pool's dtype picks the kernel, B7 for an int32 pair16 pool
        (``build_slab_pool``), B6 for a float32 narrow pool
        (``build_slab_pool_narrow``).  Equal bit for bit to :meth:`render`
        of the volume the pool was built from.  Clamp-only: a plan with
        ``wrap="repeat"`` raises.  The kernel writes the displayed image, as
        for :meth:`render`.  Returns (rgb (H, W, 3), alpha (H, W))."""
        dims = pool_dims(pool, slab_map)
        if dims != self.dims:
            raise ValueError(f"the pool holds a volume of (X, Y, Z) = {dims}, the plan's is "
                             f"{self.dims}")
        march = (composite_march_pooled_pair16_cuda if pool.dtype == torch.int32
                 else composite_march_pooled_narrow_cuda)
        return march(pool, slab_map, self.entry_uv, self.dir_step, self.hit, self.max_samples,
                     self.wrap, transfer=True)


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
    s = _byte_values(volume)
    Z, Y, X = s.shape
    s = F.pad(s, (0, (-X) % 8, 0, (-Y) % 8, 0, (-Z) % 8))
    Zp, Yp, Xp = s.shape
    return s.reshape(Zp // 8, 8, Yp // 8, 8, Xp // 8, 8).amax(dim=(1, 3, 5))


def pack_pairs(volume: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) uint8 or float volume -> float32 pair volume ``s[x]*256 +
    s[x+1]`` of the 8-bit samples, x + 1 clamped to the edge."""
    s = _byte_values(volume)
    return s * 256.0 + torch.cat([s[:, :, 1:], s[:, :, -1:]], dim=2)


def pack_pairs16(volume: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) uint8 or float volume -> (Z, Y, X // 2) int32 holding two
    16-bit pairs per word, ``word[k] = pair16[2k] | pair16[2k+1] << 16`` with
    ``pair16[x] = s[x]*256 + s[x+1]`` (x + 1 clamped).  Requires X even."""
    if volume.dim() != 3 or volume.shape[2] % 2:
        raise ValueError(f"pair16 packing needs a (Z, Y, X) volume with X even, got "
                         f"{tuple(volume.shape)}")
    p16 = pack_pairs(volume).to(torch.int32)
    lo, hi = p16[:, :, 0::2], p16[:, :, 1::2]
    # hi << 16 as a signed word, without overflowing int32
    return torch.where(hi >= 32768, hi - 65536, hi) * 65536 | lo


SLAB_H = 16  # pool slab height: the slot of z-block b holds z rows [8b, 8b + 16)


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
    their bytes), each 16 rows from z = 8b (zero rows past Z)."""
    Z, Y, W = packed.shape
    dev = packed.device
    padded = torch.cat([packed, packed.new_zeros((8, Y, W))])
    occ_idx = np.nonzero(occ)[0]
    rows = 8 * occ_idx[:, None] + np.arange(SLAB_H)[None]
    slabs = padded[torch.as_tensor(rows, dtype=torch.int64, device=dev)]
    host = slabs.cpu().numpy()
    slots = np.zeros(Z // 8, np.int32)
    unique: dict[bytes, int] = {}
    keep: list[int] = []
    for i, b in enumerate(occ_idx):
        key = host[i].tobytes()
        slot = unique.get(key)
        if slot is None:
            slot = 1 + len(keep)
            unique[key] = slot
            keep.append(i)
        slots[b] = slot
    pool = torch.cat([packed.new_zeros((1, SLAB_H, Y, W)),
                      slabs[torch.as_tensor(keep, dtype=torch.int64, device=dev)]])
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
    return _slab_pool(pack_pairs(volume), _occupied_slabs(volume, mip8))


POOL_DTYPES = {"pair16": torch.int32, "narrow": torch.float32}


def pool_dims(pool: torch.Tensor, slab_map: torch.Tensor, fmt: str | None = None):
    """(X, Y, Z) of the volume a pool holds, after checking the pool's and
    the map's types and shapes: int32 pair16 words (n_slots, 16, Y, X // 2)
    or float32 pair values (n_slots, 16, Y, X), and a (1, Z // 8) int32 map.
    ``fmt`` ("pair16" or "narrow") requires that pool format."""
    if pool.dtype not in POOL_DTYPES.values() or pool.dim() != 4 \
            or pool.shape[1] != SLAB_H or min(pool.shape) < 1:
        raise ValueError(f"pool must be an (n_slots, {SLAB_H}, Y, W) int32 or float32 tensor, "
                         f"got {tuple(pool.shape)} {pool.dtype}")
    if fmt is not None and pool.dtype != POOL_DTYPES[fmt]:
        raise ValueError(f"the {fmt} kernels need a {POOL_DTYPES[fmt]} pool, got {pool.dtype}")
    if slab_map.dtype != torch.int32 or slab_map.dim() != 2 or slab_map.shape[0] != 1 \
            or slab_map.shape[1] < 1:
        raise ValueError(f"slab_map must be a (1, Z // 8) int32 tensor, got "
                         f"{tuple(slab_map.shape)} {slab_map.dtype}")
    W = int(pool.shape[3])
    X = 2 * W if pool.dtype == torch.int32 else W
    if max(X, pool.shape[2], pool.shape[0] * SLAB_H) > _INT32_MAX:
        raise ValueError(f"pool extent {tuple(pool.shape)} exceeds int32")
    return X, int(pool.shape[2]), 8 * int(slab_map.shape[1])


@functools.cache
def _pooled_launcher(fmt: str):
    # entry_uv, dir_step, hit, pool, slab_map; H, W, X, Y, Z, n_slots,
    # max_samples, rgb; out, alpha, stream
    return bind("composite_march", 5, 8, [ctypes.c_void_p] * 3,
                entry=f"composite_march_pooled_{fmt}")


def _composite_march_pooled(wrapper, fmt, pool, slab_map, entry_uv, dir_step, hit,
                            max_samples, wrap, transfer):
    tensors = {"pool": pool, "slab_map": slab_map, "entry_uv": entry_uv,
               "dir_step": dir_step, "hit": hit}
    check_tensors(tensors, "pool")
    dims = pool_dims(pool, slab_map, fmt)
    check_hit(hit)
    check_image(tensors, hit.shape, torch.float32, ("entry_uv", "dir_step"), (3,))
    check_max_samples(max_samples)
    check_clamp(wrap, "the pooled marches")
    if pool.device.type == "cpu":
        color, alpha = composite_march_steps(slab_pool_sampler(pool, slab_map, dims), entry_uv,
                                             dir_step, hit.to(torch.bool), max_samples,
                                             early_exit=True)
        return (apply_reference_transfer(color, alpha) if transfer else color), alpha
    H, W = hit.shape
    X, Y, Z = dims
    out = torch.empty((H, W, 3) if transfer else (H, W), dtype=torch.float32, device=pool.device)
    alpha = torch.empty((H, W), dtype=torch.float32, device=pool.device)
    if H * W == 0:
        return out, alpha
    launch(lambda: _pooled_launcher(fmt), "composite_march", pool.device,
           entry_uv.data_ptr(), dir_step.data_ptr(), hit.data_ptr(), pool.data_ptr(),
           slab_map.data_ptr(), H, W, X, Y, Z, int(pool.shape[0]), max_samples, int(transfer),
           out.data_ptr(), alpha.data_ptr())
    wrapper.launches += 1
    return out, alpha


def composite_march_pooled_narrow_cuda(pool: torch.Tensor, slab_map: torch.Tensor,
                                       entry_uv: torch.Tensor, dir_step: torch.Tensor,
                                       hit: torch.Tensor, max_samples: int = MAX_SAMPLES,
                                       wrap: str = "clamp", transfer: bool = False):
    """B6: :func:`composite_march_cuda`'s march, sampling the narrow f32
    slab pool (``build_slab_pool_narrow``) through its slab map.  Equal bit
    for bit to the dense march on the volume the pool was built from.
    ``wrap`` must be "clamp".  Returns (color, alpha), each (H, W) float32,
    or with ``transfer`` (rgb (H, W, 3), alpha) as the dense march does.
    CUDA tensors run the kernel and add one to
    ``composite_march_pooled_narrow_cuda.launches``; CPU tensors run the
    plain version."""
    return _composite_march_pooled(composite_march_pooled_narrow_cuda, "narrow", pool,
                                   slab_map, entry_uv, dir_step, hit, max_samples, wrap,
                                   transfer)


composite_march_pooled_narrow_cuda.launches = 0


def composite_march_pooled_pair16_cuda(pool: torch.Tensor, slab_map: torch.Tensor,
                                       entry_uv: torch.Tensor, dir_step: torch.Tensor,
                                       hit: torch.Tensor, max_samples: int = MAX_SAMPLES,
                                       wrap: str = "clamp", transfer: bool = False):
    """B7: as :func:`composite_march_pooled_narrow_cuda`, on the pair16 pool
    (``build_slab_pool``); adds one to
    ``composite_march_pooled_pair16_cuda.launches`` per kernel launch."""
    return _composite_march_pooled(composite_march_pooled_pair16_cuda, "pair16", pool,
                                   slab_map, entry_uv, dir_step, hit, max_samples, wrap,
                                   transfer)


composite_march_pooled_pair16_cuda.launches = 0


def render_compositing_kernel(volume, entry_uv, direction, hit,
                              max_samples: int = MAX_SAMPLES, wrap: str = "clamp"):
    """Drop-in replacement for ``render_compositing`` through the march
    kernel (both wrap modes); the volume (float32 or uint8) is sampled on
    its 8-bit grid."""
    Z, Y, X = volume.shape
    plan = CompositingPlan(entry_uv, direction, hit, (X, Y, Z), max_samples, wrap)
    return plan.render(volume)
