"""Context-parallel (z-sharded) ray marching, in plain PyTorch.

Counterpart of ``volumerenderer_tpu/parallel/context.py``.  The per-ray
sample chain is split along the march by sharding the VOLUME in z over a
mesh.  Under the compositing recurrence (``prev_alpha = s*(1-a); c +=
prev_alpha*s; a += 0.6*prev_alpha``) the transmittance ``tau = 1 - a``
evolves multiplicatively and the color additively, so a ray SEGMENT acts on
(c, tau) as the affine map ``c -> c + tau*C_seg``, ``tau -> tau*T_seg``, and
segment maps compose associatively.  Each shard marches the samples whose
anchor it owns, reading its slab plus one halo plane copied from the next
shard (the last shard repeats its own last plane: clamp-to-edge at the
volume's face), and the segments fold in per-ray traversal order.  A z-slab
is a brick that spans y and x, so each shard marches as
``parallel/bricks.py``'s do.

Exactness: equal to the single-device march *without* the a > 0.99
early-out, which needs the global alpha a shard cannot see; the omitted
contributions carry transmittance < 0.01 (``docs/PARITY.md`` deviation 6).

Positions are the JAX function's analytic ``entry + (t + 1)*step``, so that
the two plain paths agree; the kernels and their plain versions
(``ops/raycast.py::seg_march_steps``) advance by repeated addition, and the
two drift apart by rounding over many steps (ROADMAP queue C).
"""
from __future__ import annotations

import torch

from ..ops.raycast import MAX_SAMPLES, apply_reference_transfer
from .bricks import _brick_march
from .sharding import DeviceMesh, default_devices

__all__ = ["render_zsharded", "make_z_mesh", "composite_segments"]


def make_z_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """A 1-D mesh with axis ``"z"`` over ``n_devices`` devices (default: the
    ``devices`` given, else one per CUDA card, round-robin)."""
    if devices is None:
        devices = default_devices(n_devices)
    devices = list(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"a z mesh of {n} shards needs {n} devices, got {len(devices)}")
    return DeviceMesh(devices[:n], ("z",))


def composite_segments(C_all, T_all, ascending):
    """Fold (N, ...) segment maps in per-ray traversal order.

    ``ascending``: (...) bool, True where the ray moves toward +z.  Returns
    (color, alpha)."""
    N = C_all.shape[0]
    c = torch.zeros_like(C_all[0])
    tau = torch.ones_like(T_all[0])
    for i in range(N):
        Cd = torch.where(ascending, C_all[i], C_all[N - 1 - i])
        Td = torch.where(ascending, T_all[i], T_all[N - 1 - i])
        c, tau = c + tau * Cd, tau * Td
    return c, 1.0 - tau


def render_zsharded(mesh: DeviceMesh, volume, entry_uv, direction, hit,
                    max_samples: int = MAX_SAMPLES):
    """Render with the volume sharded along z over ``mesh`` axis ``"z"``.

    ``volume``: (Z, Y, X) float32 (global).  Each shard's slab and its halo
    plane go to its device, its segment maps come back to the mesh's first
    device, and they fold there.  Returns (rgb, alpha) matching the unsharded
    renderer without early termination."""
    Z, Y, X = volume.shape
    devices = list(mesh.devices.flat)
    n = mesh.shape["z"]
    if Z % n:
        raise ValueError(f"Z = {Z} does not split into {n} z-shards")
    S = Z // n
    dims = (X, Y, Z)
    slabs = [volume[i * S:(i + 1) * S].to(dev) for i, dev in enumerate(devices)]
    C_all, T_all = [], []
    for i, dev in enumerate(devices):
        # halo: the next shard's first plane; the last shard repeats its own
        # last plane (the global clamp at the z face)
        halo = slabs[i][S - 1:S] if i == n - 1 else slabs[i + 1][0:1].to(dev)
        slab_ext = torch.cat([slabs[i], halo])
        C, T, _ = _brick_march(slab_ext, entry_uv.to(dev), direction.to(dev), hit.to(dev),
                               (i * S, 0, 0), (S, Y, X), dims, max_samples)
        C_all.append(C.to(mesh.first))
        T_all.append(T.to(mesh.first))
    ascending = direction[..., 2].to(mesh.first) >= 0
    color, alpha = composite_segments(torch.stack(C_all), torch.stack(T_all), ascending)
    return apply_reference_transfer(color, alpha), alpha
