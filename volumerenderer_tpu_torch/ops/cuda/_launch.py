"""What every kernel wrapper of this package does around a launch: bind the
library's C entry point, check the tensors it is handed, and launch on the
current stream, raising on a CUDA error code."""
from __future__ import annotations

import ctypes

import torch

from ..sampling import WRAP_MODES
from . import _build

INT32_MAX = 2**31 - 1
SLAB_H = 16  # pool slab height: the slot of z-block b holds z rows [8b, 8b + 16)


def bind(name: str, n_pointers_before: int, n_ints: int, tail, entry: str | None = None):
    """Build and load ``csrc/<name>.cu`` and declare ``<entry>_launch``'s
    arguments (``entry`` defaults to ``name``): pointers, then ints, then
    ``tail`` (ctypes types, ending with the stream).  Returns (launch
    function, BuiltLibrary)."""
    built = _build.load(name)
    fn = getattr(built.lib, f"{entry or name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_pointers_before + [ctypes.c_int] * n_ints + list(tail)
    fn.restype = ctypes.c_int
    err = getattr(built.lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, built


def launch(launcher, name: str, device: torch.device, *args) -> None:
    """Call ``launcher()``'s function with ``args`` and the current stream of
    ``device``; raise if it returns a CUDA error."""
    fn, built = launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = getattr(built.lib, f"{name}_error_string")(err).decode(errors="replace")
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def ptr(t):
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def check_tensors(tensors: dict, ref: str):
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    device = tensors[ref].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device} but {ref} is on {device}")


def dense_entry(name: str, volume) -> str:
    """The C entry of kernel ``name`` for ``volume``'s dtype: ``name`` reads
    a uint8 volume's bytes, ``<name>_f32`` a float32 volume's values, each
    tap quantized to 8 bits as it is read.  Any other dtype raises."""
    if volume.dtype == torch.uint8:
        return name
    if volume.dtype == torch.float32:
        return f"{name}_f32"
    raise ValueError(f"the volume must be float32 in [0, 1] or uint8, got {volume.dtype}")


def count_launch(wrapper, volume) -> None:
    """One launch of a dense-volume wrapper: one more in ``wrapper.launches``
    and, for a float32 volume (the ``_f32`` entry), in its ``f32_launches``."""
    wrapper.launches += 1
    if volume.dtype == torch.float32:
        wrapper.f32_launches += 1


def check_volume(vol, dtype=torch.uint8, name: str = "vol_u8"):
    if vol.dtype != dtype or vol.dim() != 3 or min(vol.shape) < 1:
        raise ValueError(f"{name} must be a non-empty (Z, Y, X) {str(dtype)[6:]} tensor, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    if max(vol.shape) > INT32_MAX:
        raise ValueError(f"volume extent {tuple(vol.shape)} exceeds int32")


def check_shape(volume, dims) -> None:
    """Raise ValueError unless ``volume`` has the (Z, Y, X) shape of ``dims``
    = (X, Y, Z)."""
    X, Y, Z = dims
    if tuple(volume.shape) != (Z, Y, X):
        raise ValueError(f"volume shape {tuple(volume.shape)} does not match the "
                         f"plan's (Z, Y, X) = {(Z, Y, X)}")


def _check_index(name: str, value) -> int:
    if isinstance(value, bool) or not isinstance(value, int) or not 0 <= value <= INT32_MAX:
        raise ValueError(f"{name} must be a non-negative int, got {value!r}")
    return value


def check_box(dims, z_lo, n_z, y_lo, n_y):
    """The checks of a shard's owned anchor box [z_lo, z_lo + n_z) x
    [y_lo, y_lo + n_y) in a volume of ``dims = (X, Y, Z)`` (a z-slab:
    y_lo = 0, n_y = Y).  Returns the box (z_lo, z_hi, y_lo, y_hi)."""
    if len(dims) != 3:
        raise ValueError(f"dims must be (X, Y, Z), got {dims!r}")
    X, Y, Z = (_check_index("dims", d) for d in dims)
    z_lo, n_z = _check_index("z_lo", z_lo), _check_index("n_z", n_z)
    y_lo, n_y = _check_index("y_lo", y_lo), _check_index("n_y", n_y)
    if n_z < 1 or n_y < 1 or z_lo + n_z > Z or y_lo + n_y > Y:
        raise ValueError(f"owned box z [{z_lo}, {z_lo + n_z}) x y [{y_lo}, {y_lo + n_y}) is "
                         f"empty or leaves the volume's (Z, Y) = ({Z}, {Y})")
    return z_lo, z_lo + n_z, y_lo, y_lo + n_y


def check_shard(slab, dims, z_lo, n_z, y_lo, n_y):
    """The checks of a segment march's shard arguments: ``slab`` (Ez, Ey, X)
    uint8 holds the global rows [z_lo, z_lo + Ez) x [y_lo, y_lo + Ey) of a
    volume of ``dims = (X, Y, Z)``, and the shard owns the anchors of
    :func:`check_box`.  The slab must hold every tap of an owned anchor: the
    owned rows and one halo plane and row past them, where the volume has
    one.  Returns the owned box (z_lo, z_hi, y_lo, y_hi)."""
    box = check_box(dims, z_lo, n_z, y_lo, n_y)
    X, Y, Z = dims
    if slab.dtype != torch.uint8 or slab.dim() != 3:
        raise ValueError(f"slab must be an (Ez, Ey, X) uint8 tensor, got {tuple(slab.shape)} "
                         f"{slab.dtype}")
    Ez, Ey, Xs = slab.shape
    need = (min(n_z + 1, Z - z_lo), min(n_y + 1, Y - y_lo), X)
    if Xs != X or Ez < need[0] or Ey < need[1]:
        raise ValueError(f"slab {tuple(slab.shape)} does not hold the owned box and its halo: "
                         f"needs at least {need}")
    if max(Ez, Ey) > INT32_MAX:
        raise ValueError(f"slab extent {tuple(slab.shape)} exceeds int32")
    return box


def check_image(tensors: dict, shape, dtype, names, suffix=()):
    want = tuple(shape) + tuple(suffix)
    for name in names:
        t = tensors[name]
        if t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(f"{name} must be an {want} {dtype} tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")


def check_hit(hit):
    if hit.dtype != torch.uint8 or hit.dim() != 2:
        raise ValueError(f"hit must be an (H, W) uint8 tensor, got {tuple(hit.shape)} {hit.dtype}")


def check_max_samples(max_samples):
    if isinstance(max_samples, bool) or not isinstance(max_samples, int) \
            or not 0 <= max_samples <= INT32_MAX:
        raise ValueError(f"max_samples must be a non-negative int, got {max_samples!r}")


def check_clamp(wrap: str, what: str) -> None:
    """Raise ValueError unless ``wrap`` is "clamp": ``what`` (e.g. "the
    pooled marches") are clamp-only."""
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")
    if wrap != "clamp":
        raise ValueError(f"{what} are clamp-only, got wrap={wrap!r}")


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
    if max(X, pool.shape[2], pool.shape[0] * SLAB_H) > INT32_MAX:
        raise ValueError(f"pool extent {tuple(pool.shape)} exceeds int32")
    return X, int(pool.shape[2]), 8 * int(slab_map.shape[1])
