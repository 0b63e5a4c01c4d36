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

A z mesh over several processes (``multihost.global_mesh(("z",))``) takes the
volume placed by ``bricks.shard_volume`` (each process's slab, with its
offset): each process marches its own shards, the halo plane comes from the
next shard wherever it lies, and the segment maps gather in mesh order
(``multihost.gather``), so every process folds the same tensors in the same
order as one process does and returns the full image.
"""
from __future__ import annotations

import torch

from ..ops.raycast import MAX_SAMPLES, apply_reference_transfer
from . import multihost
from .bricks import _brick_march, as_sharded, extend_halos
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

    ``volume``: (Z, Y, X) float32 (global), or a ``ShardedVolume`` of this
    mesh (``bricks.shard_volume``).  Each of this process's shards gets its
    slab and halo plane on its device, its segment maps gather in mesh order
    (on the mesh's first device in one process, on every process over
    several), and they fold there.  Returns (rgb, alpha) matching the
    unsharded renderer without early termination."""
    if mesh.devices.ndim != 1:
        raise ValueError(f"expected a 1-D z mesh, got {mesh.axis_names}")
    sv = as_sharded(mesh, volume)
    Z, Y, X = sv.shape
    S = Z // mesh.size
    # halo: the next shard's first plane; the last shard repeats its own
    # last plane (the global clamp at the z face)
    ext = extend_halos(sv.bricks, axes=(0,), mesh=mesh)
    local = []
    for i in mesh.local_indices():
        slab_ext = ext[i, 0, 0]
        dev = slab_ext.device
        C, T, _ = _brick_march(slab_ext, entry_uv.to(dev), direction.to(dev), hit.to(dev),
                               (i * S, 0, 0), (S, Y, X), (X, Y, Z), max_samples)
        local.append((C, T))
    C_all, T_all = (torch.stack(f) for f in zip(*multihost.gather(mesh, local)))
    ascending = direction[..., 2].to(mesh.home) >= 0
    color, alpha = composite_segments(C_all, T_all, ascending)
    return apply_reference_transfer(color, alpha), alpha
