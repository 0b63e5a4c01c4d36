"""Packed 2-bit code arrays, the layout of the reference's ``TwoBitArray``.

Counterpart of ``volumerenderer_tpu/utils/bitarray.py``: 4 two-bit codes per
byte, LSB-first, element ``i`` in byte ``i // 4`` at bit ``(i & 3) * 2``.
``pack2_np`` / ``unpack2_np`` run on the host (numpy), ``pack2`` / ``unpack2``
on a uint8 tensor on its own device.  The 4-bit helpers pack 2 values per
byte, LSB-first: the intended semantics of the reference ``FourBitArray``,
whose getter and setter keep only the low bit of each nibble
(``FourBitArray.h:30-39``), as the JAX package implements them.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack2_np", "unpack2_np", "pack2", "unpack2", "pack4_np", "unpack4_np", "pack4",
           "unpack4", "packed2_nbytes"]


def packed2_nbytes(n: int) -> int:
    """Bytes needed for ``n`` 2-bit codes: (n + 3) // 4."""
    return (n + 3) // 4


def pack2_np(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes (values 0..3) into bytes, 4 codes per byte LSB-first."""
    codes = np.asarray(codes, dtype=np.uint8).ravel()
    n = codes.shape[0]
    padded = np.zeros(packed2_nbytes(n) * 4, dtype=np.uint8)
    padded[:n] = codes & 3
    quads = padded.reshape(-1, 4)
    return (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
            | (quads[:, 3] << 6)).astype(np.uint8)


def unpack2_np(packed: np.ndarray, n: int | None = None) -> np.ndarray:
    """Unpack bytes into 2-bit codes; returns ``n`` codes (default 4 per byte)."""
    packed = np.asarray(packed, dtype=np.uint8).ravel()
    out = np.empty(packed.shape[0] * 4, dtype=np.uint8)
    out[0::4] = packed & 3
    out[1::4] = (packed >> 2) & 3
    out[2::4] = (packed >> 4) & 3
    out[3::4] = (packed >> 6) & 3
    return out if n is None else out[:n]


def pack4_np(vals: np.ndarray) -> np.ndarray:
    """Pack 4-bit values (0..15) into bytes, 2 values per byte LSB-first."""
    vals = np.asarray(vals, dtype=np.uint8).ravel()
    n = vals.shape[0]
    padded = np.zeros(((n + 1) // 2) * 2, dtype=np.uint8)
    padded[:n] = vals & 0xF
    pairs = padded.reshape(-1, 2)
    return (pairs[:, 0] | (pairs[:, 1] << 4)).astype(np.uint8)


def unpack4_np(packed: np.ndarray, n: int | None = None) -> np.ndarray:
    """Unpack bytes into 4-bit values; returns ``n`` values (default 2 per byte)."""
    packed = np.asarray(packed, dtype=np.uint8).ravel()
    out = np.empty(packed.shape[0] * 2, dtype=np.uint8)
    out[0::2] = packed & 0xF
    out[1::2] = (packed >> 4) & 0xF
    return out if n is None else out[:n]


def _check_u8(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.uint8:
        raise ValueError(f"{what} must be uint8, got {t.dtype}")


def pack2(codes: torch.Tensor) -> torch.Tensor:
    """Codes (..., 4k) uint8 -> bytes (..., k) uint8, on the input's device.
    The last axis must be a multiple of 4 (callers pad)."""
    _check_u8(codes, "codes")
    quads = (codes & 3).reshape(codes.shape[:-1] + (-1, 4))
    return (quads[..., 0] | (quads[..., 1] << 2) | (quads[..., 2] << 4)
            | (quads[..., 3] << 6))


def pack4(vals: torch.Tensor) -> torch.Tensor:
    """Values (..., 2k) uint8 -> bytes (..., k) uint8, on the input's device.
    The last axis must be even (callers pad)."""
    _check_u8(vals, "values")
    pairs = (vals & 0xF).reshape(vals.shape[:-1] + (-1, 2))
    return pairs[..., 0] | (pairs[..., 1] << 4)


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Bytes (..., k) uint8 -> values (..., 2k) uint8, on the input's device."""
    _check_u8(packed, "packed values")
    shifts = torch.tensor([0, 4], dtype=torch.uint8, device=packed.device)
    vals = (packed.unsqueeze(-1) >> shifts) & 0xF
    return vals.reshape(packed.shape[:-1] + (-1,))


def unpack2(packed: torch.Tensor) -> torch.Tensor:
    """Bytes (..., k) uint8 -> codes (..., 4k) uint8, on the input's device."""
    _check_u8(packed, "packed codes")
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=packed.device)
    codes = (packed.unsqueeze(-1) >> shifts) & 3
    return codes.reshape(packed.shape[:-1] + (-1,))
