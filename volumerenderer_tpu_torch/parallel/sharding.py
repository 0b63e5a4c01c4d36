"""Device meshes, and the TF render and fit step with image rows sharded over
one.

Counterpart of ``volumerenderer_tpu/parallel/sharding.py`` (``make_mesh``,
``render_tf_sharded``, ``tf_fit_step``).  ``DeviceMesh`` stands in for
``jax.sharding.Mesh``: named axes over an array of ``torch.device``s.  Where
JAX runs one ``shard_map`` body per device, the port runs the shards one
after another from one process, each on its device; the collectives are
tensor copies between the mesh's devices (``.to(device)``, peer copies
between cards) and sums on the mesh's first device.  Gradients flow through
those copies by torch autograd.

A mesh with no ``devices`` spreads its shards round-robin over the host's
CUDA cards, so four shards share ``cuda:0`` on a one-card host; a caller
that wants the CPU passes ``devices=[torch.device("cpu")] * n``.  Not ported
yet: ``scaling_efficiency_probe`` and the processes of ``multihost.py``
(``torch.distributed``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..diff.transfer import TFParams, render_tf
from ..ops.raycast import MAX_SAMPLES

__all__ = ["DeviceMesh", "default_devices", "make_mesh", "render_tf_sharded", "tf_fit_step"]


class DeviceMesh:
    """Named axes over an array of devices (``jax.sharding.Mesh``'s role).

    ``devices`` is a nested list or array of ``torch.device`` (or names)
    whose shape gives the axes' sizes; ``axis_names`` names them in order.
    """

    def __init__(self, devices, axis_names):
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        shape = np.shape(np.asarray(devices, dtype=object))
        if len(shape) != len(axis_names) or not flat:
            raise ValueError(f"a mesh of shape {shape} cannot take the axes {axis_names}")
        arr = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            arr[i] = torch.device(d)
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The device the collectives sum on and the results land on."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(self.devices[tuple(index)])
        return out

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def default_devices(n: int | None = None) -> list[torch.device]:
    """``n`` devices round-robin over the host's CUDA cards (``n`` defaults
    to their count).  Raises without a CUDA device: a CPU mesh is asked for
    by passing its devices."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device for the mesh; pass devices=[torch.device('cpu')] * n "
                           "for a mesh on the CPU")
    n = count if n is None else int(n)
    return [torch.device("cuda", i % count) for i in range(n)]


def make_mesh(n_devices: int | None = None, dp: int = 1, devices=None) -> DeviceMesh:
    """A ``(dp, rays)`` mesh over ``n_devices`` devices (default: the
    ``devices`` given, else one per CUDA card)."""
    if devices is None:
        devices = default_devices(n_devices)
    devices = list(devices)
    n = len(devices) if n_devices is None else int(n_devices)
    if n % dp or n > len(devices):
        raise ValueError(f"{n} devices (of {len(devices)}) do not split into dp={dp}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = d
    return DeviceMesh(grid.reshape(dp, n // dp), ("dp", "rays"))


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} of {n} does not split into {parts} shards")
    return n // parts


def render_tf_sharded(mesh: DeviceMesh, params: TFParams, volume, entry_uv, direction, hit,
                      max_samples: int = MAX_SAMPLES):
    """Render one view with image rows sharded over the ``rays`` axis: each
    device renders its rows with ``render_tf`` (volume and params copied to
    it), and the rows gather on the mesh's first device.  Differentiable."""
    devices = mesh.axis_devices("rays")
    rows = _split(entry_uv.shape[0], len(devices), "image height")
    rgbs, alphas = [], []
    for j, dev in enumerate(devices):
        r = slice(j * rows, (j + 1) * rows)
        p = TFParams(*(t.to(dev) for t in params))
        rgb, alpha = render_tf(p, volume.to(dev), entry_uv[r].to(dev), direction[r].to(dev),
                               hit[r].to(dev), max_samples)
        rgbs.append(rgb.to(mesh.first))
        alphas.append(alpha.to(mesh.first))
    return torch.cat(rgbs), torch.cat(alphas)


def tf_fit_step(mesh: DeviceMesh, params: TFParams, volume, entry_uv, direction, hit, target_rgb,
                lr: float = 1e-2, max_samples: int = MAX_SAMPLES):
    """One SGD step of the TF fit, sharded: the batch of views over ``dp``,
    image rows over ``rays``; each shard's squared-error sum is copied to the
    first device and summed there (the psum), and one backward through the
    copies gives the summed gradients.

    Shapes: entry_uv/direction (B, H, W, 3), hit (B, H, W), target (B, H, W,
    3).  Returns (new_params, loss) on the mesh's first device."""
    n_dp, n_rays = mesh.shape["dp"], mesh.shape["rays"]
    B, H = entry_uv.shape[:2]
    nb = _split(B, n_dp, "batch")
    nh = _split(H, n_rays, "image height")
    leaves = TFParams(*(p.detach().to(mesh.first).requires_grad_(True) for p in params))
    total = torch.zeros((), dtype=torch.float32, device=mesh.first)
    for i in range(n_dp):
        for j in range(n_rays):
            dev = mesh.devices[i, j]
            b, r = slice(i * nb, (i + 1) * nb), slice(j * nh, (j + 1) * nh)
            p = TFParams(*(t.to(dev) for t in leaves))
            rgb, _ = render_tf(p, volume.to(dev), entry_uv[b, r].to(dev),
                               direction[b, r].to(dev), hit[b, r].to(dev), max_samples)
            local = torch.sum((rgb - target_rgb[b, r].to(dev)) ** 2)
            total = total + local.to(mesh.first)
    grads = torch.autograd.grad(total, leaves)
    n = target_rgb.numel()
    new_params = TFParams(*(p.detach() - lr * g / n for p, g in zip(leaves, grads)))
    return new_params, total.detach() / n
