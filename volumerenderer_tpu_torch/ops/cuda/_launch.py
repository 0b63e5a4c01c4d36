"""What every kernel wrapper of this package does around a launch: bind the
library's C entry point, check the tensors it is handed, and launch on the
current stream, raising on a CUDA error code."""
from __future__ import annotations

import ctypes

import torch

from ..sampling import WRAP_MODES
from . import _build

INT32_MAX = 2**31 - 1


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


def check_volume(vol, dtype=torch.uint8, name: str = "vol_u8"):
    if vol.dtype != dtype or vol.dim() != 3 or min(vol.shape) < 1:
        raise ValueError(f"{name} must be a non-empty (Z, Y, X) {str(dtype)[6:]} tensor, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    if max(vol.shape) > INT32_MAX:
        raise ValueError(f"volume extent {tuple(vol.shape)} exceeds int32")


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
