"""The card's peaks the rooflines divide by: NVIDIA's H100 SXM data sheet,
dense rates at the full 700 W power limit (the run prints the card's limit
beside every roofline)."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores: the renderer has no matrix product


def least_time(n_bytes: float, ops: float) -> float:
    """The least seconds the card needs to move ``n_bytes`` and do ``ops``
    float32 operations: the larger of the two bounds."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
