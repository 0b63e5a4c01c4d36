"""Compositing march on the GPU: the launch wrapper of
``csrc/composite_march.cu`` and the plan-once / render-many API.

Counterpart of ``volumerenderer_tpu/ops/pallas/raycast_kernel.py``
(``CompositingPlan``, ``render_compositing_pallas``).  The TPU plan's
prepasses (footprint scan, DMA word tables, ray packing into lane tiles, the
window-height cost model) only feed the TPU kernel's DMA windows; the CUDA
kernel reads the volume straight from device memory, so a plan here is the
ray tensors on the device plus the per-step increment.

``composite_march_cuda`` dispatches on where its tensors lie: CUDA tensors
launch the kernel, CPU tensors run the plain PyTorch version
(``ops/raycast.py::composite_march_steps``).  There is no fallback from one to
the other: a CUDA input the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..raycast import (MAX_SAMPLES, apply_reference_transfer, composite_march_steps,
                       step_sizes)
from ..sampling import WRAP_MODES, as_normalized_volume
from . import _build

__all__ = ["composite_march_cuda", "quantize_u8", "CompositingPlan",
           "render_compositing_kernel", "load_kernel"]

_INT32_MAX = 2**31 - 1


def load_kernel() -> _build.BuiltLibrary:
    """Build (at first use) and load the march kernel's library."""
    return _launcher()[1]


@functools.cache
def _launcher():
    built = _build.load("composite_march")
    fn = built.lib.composite_march_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    err = built.lib.composite_march_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, built


def _check_inputs(vol_u8, entry_uv, dir_step, hit, max_samples, wrap):
    tensors = {"vol_u8": vol_u8, "entry_uv": entry_uv, "dir_step": dir_step, "hit": hit}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    device = vol_u8.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device} but vol_u8 is on {device}")
    if vol_u8.dtype != torch.uint8 or vol_u8.dim() != 3 or min(vol_u8.shape) < 1:
        raise ValueError(f"vol_u8 must be a non-empty (Z, Y, X) uint8 tensor, got "
                         f"{tuple(vol_u8.shape)} {vol_u8.dtype}")
    if max(vol_u8.shape) > _INT32_MAX:
        raise ValueError(f"volume extent {tuple(vol_u8.shape)} exceeds int32")
    if hit.dtype != torch.uint8 or hit.dim() != 2:
        raise ValueError(f"hit must be an (H, W) uint8 tensor, got {tuple(hit.shape)} {hit.dtype}")
    H, W = hit.shape
    for name in ("entry_uv", "dir_step"):
        t = tensors[name]
        if t.dtype != torch.float32 or tuple(t.shape) != (H, W, 3):
            raise ValueError(f"{name} must be an ({H}, {W}, 3) float32 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if isinstance(max_samples, bool) or not isinstance(max_samples, int) \
            or not 0 <= max_samples <= _INT32_MAX:
        raise ValueError(f"max_samples must be a non-negative int, got {max_samples!r}")
    if wrap not in WRAP_MODES:
        raise ValueError(f"unknown wrap mode: {wrap}")


def composite_march_cuda(vol_u8: torch.Tensor, entry_uv: torch.Tensor, dir_step: torch.Tensor,
                         hit: torch.Tensor, max_samples: int = MAX_SAMPLES,
                         wrap: str = "clamp"):
    """March an (H, W) ray image through the 8-bit volume.

    Args:
      vol_u8: (Z, Y, X) uint8 volume, x fastest.
      entry_uv: (H, W, 3) float32 cube entry points in texture space.
      dir_step: (H, W, 3) float32 per-step increment (direction / dims).
      hit: (H, W) uint8, nonzero where the ray enters the cube.
      wrap: "clamp" (clamp-to-edge) or "repeat" (GL_REPEAT).

    Returns (color, alpha), each (H, W) float32.  CUDA tensors run the kernel
    and add one to ``composite_march_cuda.launches``; CPU tensors run the
    plain version.
    """
    _check_inputs(vol_u8, entry_uv, dir_step, hit, max_samples, wrap)
    if vol_u8.device.type == "cpu":
        return composite_march_steps(as_normalized_volume(vol_u8), entry_uv, dir_step,
                                     hit.to(torch.bool), max_samples, wrap, early_exit=True)
    H, W = hit.shape
    Z, Y, X = vol_u8.shape
    color = torch.empty((H, W), dtype=torch.float32, device=vol_u8.device)
    alpha = torch.empty_like(color)
    if H * W == 0:
        return color, alpha
    launch, built = _launcher()
    with torch.cuda.device(vol_u8.device):
        stream = torch.cuda.current_stream(vol_u8.device).cuda_stream
        err = launch(entry_uv.data_ptr(), dir_step.data_ptr(), hit.data_ptr(),
                     vol_u8.data_ptr(), H, W, X, Y, Z, max_samples,
                     int(wrap == "repeat"), color.data_ptr(), alpha.data_ptr(), stream)
    if err != 0:
        msg = built.lib.composite_march_error_string(err).decode(errors="replace")
        raise RuntimeError(f"composite_march kernel launch failed: CUDA error {err} ({msg})")
    composite_march_cuda.launches += 1
    return color, alpha


composite_march_cuda.launches = 0


def quantize_u8(volume: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) float32 in [0, 1] -> uint8 ``round(clamp(v, 0, 1) * 255)``,
    the 8-bit grid the TPU kernel samples too.  Exact for volumes made by
    ``as_normalized_volume`` from bytes."""
    return torch.round(torch.clamp(volume, 0.0, 1.0) * 255.0).to(torch.uint8)


class CompositingPlan:
    """Plan-once / render-many compositing for a fixed ray bundle.

    Keeps the rays on their device: ``entry_uv`` float32, ``dir_step =
    direction * (1/X, 1/Y, 1/Z)`` and ``hit`` as uint8.  ``dims`` is
    (X, Y, Z).  ``render`` runs the CUDA kernel when the rays lie on a CUDA
    device and the plain PyTorch march when they lie on the CPU.
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

    def check_volume(self, volume: torch.Tensor) -> None:
        """Raise ValueError unless ``volume`` has the plan's (Z, Y, X) shape."""
        X, Y, Z = self.dims
        if tuple(volume.shape) != (Z, Y, X):
            raise ValueError(f"volume shape {tuple(volume.shape)} does not match the "
                             f"plan's (Z, Y, X) = {(Z, Y, X)}")

    def render(self, volume: torch.Tensor):
        """volume: (Z, Y, X) float32 in [0, 1], on the plan's device.  It is
        quantized to 8 bits, marched, and passed through the reference
        transfer.  Returns (rgb (H, W, 3), alpha (H, W))."""
        self.check_volume(volume)
        color, alpha = composite_march_cuda(quantize_u8(volume), self.entry_uv, self.dir_step,
                                            self.hit, self.max_samples, self.wrap)
        return apply_reference_transfer(color, alpha), alpha


def render_compositing_kernel(volume, entry_uv, direction, hit,
                              max_samples: int = MAX_SAMPLES, wrap: str = "clamp"):
    """Drop-in replacement for ``render_compositing`` through the march
    kernel (both wrap modes); the volume is sampled on its 8-bit grid."""
    Z, Y, X = volume.shape
    plan = CompositingPlan(entry_uv, direction, hit, (X, Y, Z), max_samples, wrap)
    return plan.render(volume)
