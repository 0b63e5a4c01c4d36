"""Isosurface render on the GPU: the launch wrappers of ``csrc/iso_march.cu``
and ``csrc/iso_shade.cu`` and the plan-once / render-many API.

Counterpart of ``volumerenderer_tpu/ops/pallas/isosurface_kernel.py``
(``IsosurfacePlan``, ``render_isosurface_pallas``).  As for the compositing
plan (``raycast_kernel.py``), the TPU plan's prepasses only feed the TPU
kernels' DMA windows and are not carried over, and neither are the shade
windows and their pads: the CUDA kernels read the volume straight from device
memory.  A plan here is the ray tensors on the device plus the per-step
increment; ``render`` quantizes a float32 volume to 8 bits once (a uint8
volume is its own bytes) and runs the march
and then the shade pass on it, the march handing each hit's bracket (its
position at the crossing, ``near``) to the shade.  ``bind`` is the exact
empty-space skip: one ``BlockBound`` (isovalue, dims, wrap, the min/max
block grid of a volume or a slab pool, in place of the TPU plan's word
tables, and that data's identity; ``blockgrid_kernel.bind_grid``, the
compositing plan's bind too) that ``render`` and ``render_pooled`` take and
check against their isovalue and data.  The grid depends only on the data
and the wrap, so one bound serves every plan of the same dims and wrap, and
a bind of data bound before, unchanged since, reuses its grid.

The pooled render (``IsosurfacePlan.render_pooled``) marches a slab pool
(``raycast_kernel.py::build_slab_pool_narrow`` for B8,
``build_slab_pool`` for B9) and shades from the same pool.  The JAX package
shades pooled renders from a second, packed-neighbourhood pool because its
shade taps overrun the TPU march windows; the GPU kernels have no windows,
so there is no second pool.

Each wrapper dispatches on where its tensors lie: CUDA tensors launch the
kernel, CPU tensors run the plain PyTorch version
(``ops/isosurface.py::iso_march_steps`` and ``::shade_hits``, with
``ops/sampling.py::slab_pool_sampler`` for the pooled ones).  There is no
fallback from one to the other: a CUDA input the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
import numbers

import torch

from ...utils.timer import span
from ..blockgrid import BlockBound, check_bound
from ..isosurface import MAX_SAMPLES, iso_march_steps, shade_hits
from ..sampling import WRAP_MODES, as_normalized_volume, slab_pool_sampler
from . import _build
from ._launch import (bind, check_clamp, check_hit, check_image, check_max_samples,
                      check_shape, check_tensors, check_volume, launch, pool_dims, ptr)
from .blockgrid_kernel import bind_grid
from .raycast_kernel import init_plan, quantize_u8

__all__ = ["iso_march_cuda", "iso_shade_cuda", "iso_march_pooled_narrow_cuda",
           "iso_march_pooled_pair16_cuda", "iso_shade_pooled_cuda", "IsosurfacePlan",
           "render_isosurface_kernel", "volume_median", "load_kernels"]


@functools.cache
def _march_launcher():
    # entry_uv, dir_step, hit, vol, grid; H, W, X, Y, Z, max_samples, repeat; iso; found,
    # t_hit, near, stream
    return bind("iso_march", 5, 7, [ctypes.c_float] + [ctypes.c_void_p] * 4)


@functools.cache
def _shade_launcher():
    # entry_uv, dir_step, direction, found, t_hit, near, vol; H, W, X, Y, Z, repeat; iso;
    # rgb, stream
    return bind("iso_shade", 7, 6, [ctypes.c_float] + [ctypes.c_void_p] * 2)


@functools.cache
def _pooled_march_launcher(fmt: str):
    # entry_uv, dir_step, hit, pool, slab_map, grid; H, W, X, Y, Z, n_slots,
    # max_samples; iso; found, t_hit, near, stream
    return bind("iso_march", 6, 7, [ctypes.c_float] + [ctypes.c_void_p] * 4,
                entry=f"iso_march_pooled_{fmt}")


@functools.cache
def _pooled_shade_launcher(fmt: str):
    # entry_uv, dir_step, direction, found, t_hit, near, pool, slab_map; H, W,
    # X, Y, Z, n_slots; iso; rgb, stream
    return bind("iso_shade", 8, 6, [ctypes.c_float] + [ctypes.c_void_p] * 2,
                entry=f"iso_shade_pooled_{fmt}")


def load_kernels() -> dict[str, _build.BuiltLibrary]:
    """Build (at first use, both sources at once) and load the march and
    shade kernels' libraries."""
    _build.load_many(["iso_march", "iso_shade"])
    return {"iso_march": _march_launcher()[1], "iso_shade": _shade_launcher()[1]}


def _check_scalars(iso, wrap):
    if isinstance(iso, bool) or not isinstance(iso, numbers.Real) or not math.isfinite(iso):
        raise ValueError(f"iso must be a finite real number, got {iso!r}")
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")


def _march_outputs(H, W, device, with_near):
    """The march's found, t_hit and, with ``with_near``, near (else None),
    allocated on ``device``."""
    found = torch.empty((H, W), dtype=torch.uint8, device=device)
    t_hit = torch.empty((H, W), dtype=torch.int32, device=device)
    near = torch.empty((H, W, 3), dtype=torch.float32, device=device) if with_near else None
    return found, t_hit, near


def _march_result(found, t_hit, near):
    found = found.view(torch.bool)
    return (found, t_hit) if near is None else (found, t_hit, near)


def _bracket(t_hit, near) -> dict:
    """The shade's bracket tensors that were given, by name."""
    return {k: v for k, v in (("t_hit", t_hit), ("near", near)) if v is not None}


def _check_shade_inputs(tensors: dict, found, t_hit, near):
    """The shade's checks of ``found`` and of its bracket: ``near`` (H, W, 3)
    float32, or without it ``t_hit`` (H, W) int32."""
    if found.dtype != torch.bool or found.dim() != 2:
        raise ValueError(f"found must be an (H, W) bool tensor, got "
                         f"{tuple(found.shape)} {found.dtype}")
    if near is not None:
        check_image(tensors, found.shape, torch.float32, ("near",), (3,))
    elif t_hit is None:
        raise ValueError("the shade needs near (the march's with_near output) or t_hit")
    else:
        check_image(tensors, found.shape, torch.int32, ("t_hit",))
    check_image(tensors, found.shape, torch.float32, ("entry_uv", "dir_step", "direction"),
                (3,))


def iso_march_cuda(vol_u8: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                   hit: torch.Tensor, iso: float, max_samples: int = MAX_SAMPLES,
                   wrap: str = "clamp", bound: BlockBound | None = None,
                   with_near: bool = False):
    """March an (H, W) ray image through the 8-bit volume to the first upward
    crossing of ``iso`` (on the normalized [0, 1] scale).

    Args:
      vol_u8: (Z, Y, X) uint8 volume, x fastest.
      entry_uv: (H, W, 3) float32 cube entry points in texture space.
      dir_step: (H, W, 3) float32 per-step increment (direction / dims).
      hit: (H, W) uint8, nonzero where the ray enters the cube.
      wrap: "clamp" (clamp-to-edge) or "repeat" (GL_REPEAT).
      bound: None, or a ``BlockBound`` of this volume made for ``iso``
        and ``wrap`` (``IsosurfacePlan.bind``): samples in blocks wholly
        below or above iso are skipped, the result is the same bit for bit.
        A bound for another isovalue, dims or wrap raises ValueError; that
        it describes this volume, the caller answers for
        (``IsosurfacePlan.render`` checks it).

      with_near: also return near (H, W, 3) float32, each hit's position at
        its crossing (``entry_uv`` plus ``t_hit + 1`` additions of
        ``dir_step``), the bracket :func:`iso_shade_cuda` takes; unspecified
        for a miss (the kernel writes the hit rays' alone).

    Returns (found (H, W) bool, t_hit (H, W) int32, -1 for a miss), and near
    with ``with_near``.  CUDA tensors run the kernel and add one to
    ``iso_march_cuda.launches``; CPU tensors run the plain version.
    """
    tensors = {"vol_u8": vol_u8, "entry_uv": entry_uv, "dir_step": dir_step, "hit": hit}
    check_tensors(tensors, "vol_u8")
    check_volume(vol_u8)
    check_hit(hit)
    check_image(tensors, hit.shape, torch.float32, ("entry_uv", "dir_step"), (3,))
    check_max_samples(max_samples)
    _check_scalars(iso, wrap)
    Z, Y, X = vol_u8.shape
    grid = check_bound(bound, (X, Y, Z), wrap, iso, vol_u8.device)
    if vol_u8.device.type == "cpu":
        return iso_march_steps(as_normalized_volume(vol_u8), entry_uv, dir_step,
                               hit.to(torch.bool), iso, max_samples, wrap, bound, with_near)
    H, W = hit.shape
    found, t_hit, near = _march_outputs(H, W, vol_u8.device, with_near)
    if H * W == 0:
        return _march_result(found, t_hit, near)
    launch(_march_launcher, "iso_march", vol_u8.device,
           entry_uv.data_ptr(), dir_step.data_ptr(), hit.data_ptr(), vol_u8.data_ptr(),
           ptr(grid), H, W, X, Y, Z, max_samples, int(wrap == "repeat"), float(iso),
           found.data_ptr(), t_hit.data_ptr(), ptr(near))
    iso_march_cuda.launches += 1
    return _march_result(found, t_hit, near)


iso_march_cuda.launches = 0


def iso_shade_cuda(vol_u8: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                   direction: torch.Tensor, found: torch.Tensor, t_hit: torch.Tensor | None,
                   iso: float, wrap: str = "clamp", near: torch.Tensor | None = None):
    """Shade the rays ``iso_march_cuda`` found: bisection, normal, Phong.

    Args:
      vol_u8: (Z, Y, X) uint8 volume, x fastest.
      entry_uv, dir_step, direction: (H, W, 3) float32; ``direction`` is the
        ray direction the headlight uses (``V = L = -direction``).
      found: (H, W) bool; t_hit: (H, W) int32, as the march returns them.
      near: None, or (H, W, 3) float32, the march's ``with_near`` output:
        the bracket is read from it (for the hit rays alone) and ``t_hit``
        is not read, may be None.  Without it each hit rebuilds its bracket
        by ``t_hit + 1`` additions; the image is the same bit for bit.

    Returns (H, W, 3) float32 rgb in [0, 1], white where ``found`` is unset.
    CUDA tensors run the kernel and add one to ``iso_shade_cuda.launches``;
    CPU tensors run the plain version.
    """
    tensors = {"vol_u8": vol_u8, "entry_uv": entry_uv, "dir_step": dir_step,
               "direction": direction, "found": found, **_bracket(t_hit, near)}
    check_tensors(tensors, "vol_u8")
    check_volume(vol_u8)
    _check_shade_inputs(tensors, found, t_hit, near)
    _check_scalars(iso, wrap)
    if vol_u8.device.type == "cpu":
        return shade_hits(as_normalized_volume(vol_u8), entry_uv, dir_step, direction, found,
                          t_hit, iso, wrap, near)
    H, W = found.shape
    Z, Y, X = vol_u8.shape
    rgb = torch.empty((H, W, 3), dtype=torch.float32, device=vol_u8.device)
    if H * W == 0:
        return rgb
    launch(_shade_launcher, "iso_shade", vol_u8.device,
           entry_uv.data_ptr(), dir_step.data_ptr(), direction.data_ptr(),
           found.view(torch.uint8).data_ptr(), ptr(t_hit), ptr(near), vol_u8.data_ptr(),
           H, W, X, Y, Z, int(wrap == "repeat"), float(iso), rgb.data_ptr())
    iso_shade_cuda.launches += 1
    return rgb


iso_shade_cuda.launches = 0


def _iso_march_pooled(wrapper, fmt, pool, slab_map, entry_uv, dir_step, hit, iso,
                      max_samples, wrap, bound, with_near):
    tensors = {"pool": pool, "slab_map": slab_map, "entry_uv": entry_uv,
               "dir_step": dir_step, "hit": hit}
    check_tensors(tensors, "pool")
    dims = pool_dims(pool, slab_map, fmt)
    check_hit(hit)
    check_image(tensors, hit.shape, torch.float32, ("entry_uv", "dir_step"), (3,))
    check_max_samples(max_samples)
    _check_scalars(iso, wrap)
    check_clamp(wrap, "the pooled marches")
    grid = check_bound(bound, dims, wrap, iso, pool.device)
    if pool.device.type == "cpu":
        return iso_march_steps(slab_pool_sampler(pool, slab_map, dims), entry_uv, dir_step,
                               hit.to(torch.bool), iso, max_samples, bound=bound,
                               with_near=with_near)
    H, W = hit.shape
    X, Y, Z = dims
    found, t_hit, near = _march_outputs(H, W, pool.device, with_near)
    if H * W == 0:
        return _march_result(found, t_hit, near)
    launch(lambda: _pooled_march_launcher(fmt), "iso_march", pool.device,
           entry_uv.data_ptr(), dir_step.data_ptr(), hit.data_ptr(), pool.data_ptr(),
           slab_map.data_ptr(), ptr(grid), H, W, X, Y, Z,
           int(pool.shape[0]), max_samples, float(iso), found.data_ptr(), t_hit.data_ptr(),
           ptr(near))
    wrapper.launches += 1
    return _march_result(found, t_hit, near)


def iso_march_pooled_narrow_cuda(pool: torch.Tensor, slab_map: torch.Tensor,
                                 entry_uv: torch.Tensor, dir_step: torch.Tensor,
                                 hit: torch.Tensor, iso: float, max_samples: int = MAX_SAMPLES,
                                 wrap: str = "clamp", bound: BlockBound | None = None,
                                 with_near: bool = False):
    """B8: :func:`iso_march_cuda`'s march, sampling the narrow f32 slab pool
    (``build_slab_pool_narrow``) through its slab map.  Equal bit for bit to
    the dense march on the volume the pool was built from.  ``wrap`` must be
    "clamp"; ``bound``, as for :func:`iso_march_cuda`, describes this pool
    (``IsosurfacePlan.render_pooled`` checks that it was bound from it).
    Returns (found (H, W) bool, t_hit (H, W) int32), and with ``with_near``
    near (H, W, 3) float32 as :func:`iso_march_cuda` does.  CUDA tensors run
    the kernel and add one to ``iso_march_pooled_narrow_cuda.launches``; CPU
    tensors run the plain version."""
    return _iso_march_pooled(iso_march_pooled_narrow_cuda, "narrow", pool, slab_map, entry_uv,
                             dir_step, hit, iso, max_samples, wrap, bound, with_near)


iso_march_pooled_narrow_cuda.launches = 0


def iso_march_pooled_pair16_cuda(pool: torch.Tensor, slab_map: torch.Tensor,
                                 entry_uv: torch.Tensor, dir_step: torch.Tensor,
                                 hit: torch.Tensor, iso: float, max_samples: int = MAX_SAMPLES,
                                 wrap: str = "clamp", bound: BlockBound | None = None,
                                 with_near: bool = False):
    """B9: as :func:`iso_march_pooled_narrow_cuda`, on the pair16 pool
    (``build_slab_pool``); adds one to ``iso_march_pooled_pair16_cuda.launches``
    per kernel launch."""
    return _iso_march_pooled(iso_march_pooled_pair16_cuda, "pair16", pool, slab_map, entry_uv,
                             dir_step, hit, iso, max_samples, wrap, bound, with_near)


iso_march_pooled_pair16_cuda.launches = 0


def iso_shade_pooled_cuda(pool: torch.Tensor, slab_map: torch.Tensor, entry_uv: torch.Tensor,
                          dir_step: torch.Tensor, direction: torch.Tensor, found: torch.Tensor,
                          t_hit: torch.Tensor | None, iso: float, wrap: str = "clamp",
                          near: torch.Tensor | None = None):
    """:func:`iso_shade_cuda`'s shade pass, sampling a slab pool of either
    format (the pool the pooled march read) through its slab map.  Equal
    bit for bit to the dense shade on the volume the pool was built from.
    ``near`` as for :func:`iso_shade_cuda` (the pooled march's ``with_near``
    output).  ``wrap`` must be "clamp".  CUDA tensors run the kernel and add
    one to ``iso_shade_pooled_cuda.launches``; CPU tensors run the plain
    version."""
    tensors = {"pool": pool, "slab_map": slab_map, "entry_uv": entry_uv, "dir_step": dir_step,
               "direction": direction, "found": found, **_bracket(t_hit, near)}
    check_tensors(tensors, "pool")
    dims = pool_dims(pool, slab_map)
    _check_shade_inputs(tensors, found, t_hit, near)
    _check_scalars(iso, wrap)
    check_clamp(wrap, "the pooled marches")
    if pool.device.type == "cpu":
        return shade_hits(slab_pool_sampler(pool, slab_map, dims), entry_uv, dir_step,
                          direction, found, t_hit, iso, near=near)
    H, W = found.shape
    X, Y, Z = dims
    rgb = torch.empty((H, W, 3), dtype=torch.float32, device=pool.device)
    if H * W == 0:
        return rgb
    fmt = "pair16" if pool.dtype == torch.int32 else "narrow"
    launch(lambda: _pooled_shade_launcher(fmt), "iso_shade", pool.device,
           entry_uv.data_ptr(), dir_step.data_ptr(), direction.data_ptr(),
           found.view(torch.uint8).data_ptr(), ptr(t_hit), ptr(near), pool.data_ptr(),
           slab_map.data_ptr(), H, W, X, Y, Z, int(pool.shape[0]), float(iso), rgb.data_ptr())
    iso_shade_pooled_cuda.launches += 1
    return rgb


iso_shade_pooled_cuda.launches = 0


def volume_median(volume: torch.Tensor) -> float:
    """The median of all samples, the mean of the two middle ones for an even
    count (as ``np.median`` and ``jnp.median`` take it; ``torch.median``
    takes the lower one).  ``bench.py``'s isovalue."""
    flat = volume.reshape(-1)
    n = flat.numel()
    if n == 0:
        raise ValueError("the median of an empty volume is undefined")
    # a sort: torch.kthvalue takes ~0.12 s per call on a 256^3 CUDA volume
    ordered = torch.sort(flat).values
    return float((ordered[(n - 1) // 2] + ordered[n // 2]) * 0.5)


class IsosurfacePlan:
    """Plan-once / render-many isosurface raycaster for a fixed ray bundle.

    Keeps the rays on their device: ``entry_uv`` and ``direction`` float32,
    ``dir_step = direction * (1/X, 1/Y, 1/Z)`` and ``hit`` as uint8.  ``dims``
    is (X, Y, Z).  ``render`` runs the CUDA kernels when the rays lie on a
    CUDA device and the plain PyTorch path when they lie on the CPU.
    """

    def __init__(self, entry_uv: torch.Tensor, direction: torch.Tensor, hit: torch.Tensor,
                 dims, max_samples: int = MAX_SAMPLES, wrap: str = "clamp"):
        self.direction = init_plan(self, entry_uv, direction, hit, dims, max_samples, wrap)

    def bind(self, volume: torch.Tensor | None = None, iso_value: float = 40.0 / 255.0,
             mip8: torch.Tensor | None = None, pool=None) -> BlockBound:
        """The exact empty-space skip of this plan's marches at ``iso_value``
        (the port of the JAX plan's ``bind``, through
        ``blockgrid_kernel.bind_grid``): a ``BlockBound`` holding the
        isovalue, the dims, the wrap, the block grid and the identity of the
        data it describes, exactly one of ``volume`` ((Z, Y, X) float32 in
        [0, 1] or uint8, the tensor later passed to :meth:`render`) and
        ``pool`` (a ``(pool, slab_map)`` pair, later passed to
        :meth:`render_pooled`; clamp only).  The grid comes from that data's
        bytes, or, given ``mip8`` (per-8^3-block maxima of the same data,
        ``codecs/device.tree_occupancy_mip8``), from the mip: max gates
        only, so it skips only blocks wholly below iso.

        Pass the bound with the same isovalue and data: a bound made for
        another isovalue, dims or wrap, or from another tensor (or one
        written in place since), raises ValueError there, so two binds
        cannot be crossed; an inference-mode tensor (no version counter)
        raises here.  The grid depends only on the data and the wrap: one
        bound serves every plan of the same dims and wrap, and ``bind_grid``
        keeps it while the data lives, so a bind of the same tensor,
        unwritten since, at another isovalue builds nothing (a lookup of a
        few microseconds).  A bind of new data, or of data written in place
        since, builds the grid (one pass over the data:
        ``iso_block_grid_cuda`` on the card, the plain ``iso_block_grid`` on
        the CPU).  Writes that torch's version counter does not see
        (``.data``, numpy or DLPack views, raw pointers) are not seen here
        either: bind a new tensor after one.  The call is one
        ``vr.iso.bind`` span, a grid build a ``vr.grid`` span inside it."""
        with span("vr.iso.bind"):
            _check_scalars(iso_value, self.wrap)
            return bind_grid(self.dims, self.wrap, self.hit.device, volume, pool, mip8,
                             iso_value)

    def render(self, volume: torch.Tensor, iso_value: float = 40.0 / 255.0,
               bound: BlockBound | None = None):
        """volume: (Z, Y, X) on the plan's device, float32 in [0, 1] or
        uint8.  A float32 volume is quantized to 8 bits (``quantize_u8``), a
        uint8 volume's bytes are read as they are (the image is the float
        volume's ``u8 / 255``); any other dtype raises.  The bytes are
        marched and shaded.  ``bound``: None, or
        :meth:`bind`'s result from this very volume tensor for
        ``iso_value`` (the march skips exactly; the image is the same).
        Returns (rgb (H, W, 3), found (H, W) bool); pixels without a hit are
        white.  The call is one ``vr.iso.render`` span."""
        with span("vr.iso.render"):
            check_shape(volume, self.dims)
            check_bound(bound, self.dims, self.wrap, iso_value, data=(volume,))
            vol_u8 = quantize_u8(volume)
            found, t_hit, near = iso_march_cuda(vol_u8, self.entry_uv, self.dir_step, self.hit,
                                                iso_value, self.max_samples, self.wrap, bound,
                                                with_near=True)
            rgb = iso_shade_cuda(vol_u8, self.entry_uv, self.dir_step, self.direction, found,
                                 t_hit, iso_value, self.wrap, near)
            return rgb, found

    def render_pooled(self, pool: torch.Tensor, slab_map: torch.Tensor,
                      iso_value: float = 40.0 / 255.0, bound: BlockBound | None = None):
        """Compressed-domain isosurface render from a slab pool on the
        plan's device: B8 marches a float32 narrow pool
        (``build_slab_pool_narrow``), B9 an int32 pair16 pool
        (``build_slab_pool``), and the pooled shade reads the same pool.
        Equal bit for bit to :meth:`render` of the volume the pool was built
        from.  ``bound``: None, or :meth:`bind`'s result from this very pool
        and slab map (``bind(pool=(pool, slab_map))``) for ``iso_value``.
        Clamp-only: a plan with ``wrap="repeat"`` raises.  Returns (rgb (H,
        W, 3), found (H, W) bool)."""
        dims = pool_dims(pool, slab_map)
        if dims != self.dims:
            raise ValueError(f"the pool holds a volume of (X, Y, Z) = {dims}, the plan's is "
                             f"{self.dims}")
        check_bound(bound, dims, self.wrap, iso_value, data=(pool, slab_map))
        march = (iso_march_pooled_pair16_cuda if pool.dtype == torch.int32
                 else iso_march_pooled_narrow_cuda)
        found, t_hit, near = march(pool, slab_map, self.entry_uv, self.dir_step, self.hit,
                                   iso_value, self.max_samples, self.wrap, bound, with_near=True)
        rgb = iso_shade_pooled_cuda(pool, slab_map, self.entry_uv, self.dir_step,
                                    self.direction, found, t_hit, iso_value, self.wrap, near)
        return rgb, found


def render_isosurface_kernel(volume, entry_uv, direction, hit, iso_value=40.0 / 255.0,
                             max_samples: int = MAX_SAMPLES, wrap: str = "clamp",
                             skip_empty: bool = False):
    """Drop-in replacement for ``render_isosurface`` through the march and
    shade kernels (both wrap modes); the volume (float32 in [0, 1] or
    uint8) is sampled on its 8-bit grid.  ``skip_empty`` binds the volume
    for this one render (``IsosurfacePlan.bind``) and marches bound, as the
    JAX function does by default; the image is the same either way.  Here
    it is off by default: the bind of a volume not bound before costs about
    what one bound frame saves, and on an H100 such a one-shot bind plus
    the bound render took 0.93-1.13x the unbound render (1024^2 rays, the
    256^3 turbulence at its median; ``chip_smoke.py``'s skip_empty phase;
    1.4-1.9x while the grid was built by torch reductions).  A volume bound
    before and unchanged since reuses its grid (``bind_grid``), so there
    the bind is a lookup.  Bind with ``IsosurfacePlan.bind`` where a volume
    is rendered more than once."""
    Z, Y, X = volume.shape
    plan = IsosurfacePlan(entry_uv, direction, hit, (X, Y, Z), max_samples, wrap)
    bound = plan.bind(volume, iso_value) if skip_empty else None
    return plan.render(volume, iso_value, bound=bound)
