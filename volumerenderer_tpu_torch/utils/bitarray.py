"""Packed 2-bit code arrays, the layout of the reference's ``TwoBitArray``.

Counterpart of ``volumerenderer_tpu/utils/bitarray.py``: 4 two-bit codes per
byte, LSB-first, element ``i`` in byte ``i // 4`` at bit ``(i & 3) * 2``.
``pack2_np`` / ``unpack2_np`` run on the host (numpy) and ``unpack2`` on a
uint8 tensor on its own device.  The 4-bit helpers are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack2_np", "unpack2_np", "unpack2", "packed2_nbytes"]


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


def unpack2(packed: torch.Tensor) -> torch.Tensor:
    """Bytes (..., k) uint8 -> codes (..., 4k) uint8, on the input's device."""
    if packed.dtype != torch.uint8:
        raise ValueError(f"packed codes must be uint8, got {packed.dtype}")
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=packed.device)
    codes = (packed.unsqueeze(-1) >> shifts) & 3
    return codes.reshape(packed.shape[:-1] + (-1,))
