"""Device meshes, and the TF render and fit step with image rows sharded over
one.

Counterpart of ``volumerenderer_tpu/parallel/sharding.py`` (``make_mesh``,
``render_tf_sharded``, ``tf_fit_step``, ``scaling_efficiency_probe``).
``DeviceMesh`` stands in for ``jax.sharding.Mesh``: named axes over an array
of ``torch.device``s, each entry owned by one process (``ranks``).  Where JAX
runs one ``shard_map`` body per device, the port runs each process's shards
one after another, each on its device.  In one process the collectives are
tensor copies between the mesh's devices (``.to(device)``, peer copies
between cards) and sums on the mesh's first device, and gradients flow
through those copies by torch autograd.  A mesh over several processes
(``multihost.global_mesh``) gathers each entry's result to every process in
mesh order (``multihost.gather``) and sums there in that order.

A mesh with no ``devices`` spreads its shards round-robin over the host's
CUDA cards, so four shards share ``cuda:0`` on a one-card host; a caller
that wants the CPU passes ``devices=[torch.device("cpu")] * n``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..diff.transfer import TFParams, render_tf
from ..ops.raycast import MAX_SAMPLES
from . import multihost

__all__ = ["DeviceMesh", "default_devices", "make_mesh", "render_tf_sharded", "tf_fit_step",
           "scaling_efficiency_probe"]


class DeviceMesh:
    """Named axes over an array of devices (``jax.sharding.Mesh``'s role).

    ``devices`` is a nested list or array of ``torch.device`` (or names)
    whose shape gives the axes' sizes; ``axis_names`` names them in order.
    ``ranks`` (same shape) names the process that owns each entry: the
    default is this process for every entry, a mesh of one process.  Each
    process marches only its own entries (:meth:`local_indices`).
    """

    def __init__(self, devices, axis_names, ranks=None):
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        shape = np.shape(np.asarray(devices, dtype=object))
        if len(shape) != len(axis_names) or not flat:
            raise ValueError(f"a mesh of shape {shape} cannot take the axes {axis_names}")
        arr = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            arr[i] = torch.device(d)
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if ranks is None:
            ranks = np.full(shape, multihost.process_index(), dtype=np.int64)
        self.ranks = np.asarray(ranks, dtype=np.int64)
        if self.ranks.shape != shape:
            raise ValueError(f"ranks of shape {self.ranks.shape} for a mesh of shape {shape}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The mesh's first device: where a one-process mesh's collectives
        sum and its results land."""
        return self.devices.flat[0]

    @property
    def multiprocess(self) -> bool:
        """True when the entries belong to more than one process."""
        return len(np.unique(self.ranks)) > 1

    def is_local(self, idx) -> bool:
        """Whether this process owns entry ``idx`` (a flat index or an index
        tuple)."""
        rank = self.ranks.flat[idx] if np.ndim(idx) == 0 else self.ranks[tuple(idx)]
        return int(rank) == multihost.process_index()

    def local_indices(self) -> list[int]:
        """The flat indices of this process's entries, in mesh order."""
        return [i for i in range(self.size) if self.is_local(i)]

    @property
    def home(self) -> torch.device:
        """Where this process's gathered results land: its first entry's
        device (the mesh's first device in one process)."""
        mine = self.local_indices()
        if not mine:
            raise ValueError(f"process {multihost.process_index()} owns no entry of {self}")
        return self.devices.flat[mine[0]]

    def axis_indices(self, axis: str) -> list[int]:
        """The flat indices of the entries along ``axis``, at index 0 of
        every other axis."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(int(np.ravel_multi_index(index, self.devices.shape)))
        return out

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis."""
        return [self.devices.flat[i] for i in self.axis_indices(axis)]

    def __repr__(self) -> str:
        ranks = f", ranks {self.ranks.reshape(-1).tolist()}" if self.multiprocess else ""
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices.flat]}{ranks})"


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
    of this process's devices renders its rows with ``render_tf`` (volume
    and params copied to it), and the rows gather in mesh order
    (``multihost.gather``: on the mesh's first device in one process, on
    every process's ``mesh.home`` over several).  Differentiable in one
    process."""
    entries = mesh.axis_indices("rays")
    rows = _split(entry_uv.shape[0], len(entries), "image height")
    local = []
    for j, i in enumerate(entries):
        if not mesh.is_local(i):
            continue
        dev = mesh.devices.flat[i]
        r = slice(j * rows, (j + 1) * rows)
        p = TFParams(*(t.to(dev) for t in params))
        local.append(render_tf(p, volume.to(dev), entry_uv[r].to(dev), direction[r].to(dev),
                               hit[r].to(dev), max_samples))
    parts = multihost.gather(mesh, local, entries)
    return torch.cat([rgb for rgb, _ in parts]), torch.cat([alpha for _, alpha in parts])


def tf_fit_step(mesh: DeviceMesh, params: TFParams, volume, entry_uv, direction, hit, target_rgb,
                lr: float = 1e-2, max_samples: int = MAX_SAMPLES):
    """One SGD step of the TF fit, sharded: the batch of views over ``dp``,
    image rows over ``rays``.  In one process each shard's squared-error sum
    is copied to the first device and summed there (the psum), and one
    backward through the copies gives the summed gradients.  Over several
    processes each shard differentiates its own sum, and the sums and
    gradients gather in mesh order and are summed in that order.

    Shapes: entry_uv/direction (B, H, W, 3), hit (B, H, W), target (B, H, W,
    3).  Returns (new_params, loss) on ``mesh.home`` (the mesh's first
    device in one process)."""
    n_dp, n_rays = mesh.shape["dp"], mesh.shape["rays"]
    B, H = entry_uv.shape[:2]
    nb = _split(B, n_dp, "batch")
    nh = _split(H, n_rays, "image height")
    n = target_rgb.numel()

    def shard_loss(i, j, p):
        dev = mesh.devices[i, j]
        b, r = slice(i * nb, (i + 1) * nb), slice(j * nh, (j + 1) * nh)
        rgb, _ = render_tf(TFParams(*(t.to(dev) for t in p)), volume.to(dev),
                           entry_uv[b, r].to(dev), direction[b, r].to(dev), hit[b, r].to(dev),
                           max_samples)
        return torch.sum((rgb - target_rgb[b, r].to(dev)) ** 2)

    if not mesh.multiprocess:
        leaves = TFParams(*(p.detach().to(mesh.first).requires_grad_(True) for p in params))
        total = torch.zeros((), dtype=torch.float32, device=mesh.first)
        for i in range(n_dp):
            for j in range(n_rays):
                total = total + shard_loss(i, j, leaves).to(mesh.first)
        grads = torch.autograd.grad(total, leaves)
        new_params = TFParams(*(p.detach() - lr * g / n for p, g in zip(leaves, grads)))
        return new_params, total.detach() / n
    local = []
    for i, j in np.ndindex(n_dp, n_rays):
        if mesh.is_local((i, j)):
            leaves = TFParams(*(p.detach().to(mesh.devices[i, j]).requires_grad_(True)
                                for p in params))
            loss = shard_loss(i, j, leaves)
            local.append((loss.detach(), *torch.autograd.grad(loss, leaves)))
    home = mesh.home
    total = torch.zeros((), dtype=torch.float32, device=home)
    grads = [torch.zeros(p.shape, dtype=p.dtype, device=home) for p in params]
    for loss, *g in multihost.gather(mesh, local):
        total = total + loss
        grads = [a + b for a, b in zip(grads, g)]
    new_params = TFParams(*(p.detach().to(home) - lr * g / n for p, g in zip(params, grads)))
    return new_params, total / n


def scaling_efficiency_probe(mesh: DeviceMesh, volume, entry_uv, direction, hit,
                             max_samples: int = MAX_SAMPLES, frames: int = 4) -> float:
    """Render with :func:`render_tf_sharded` on the full mesh and on a mesh
    of this process's first device alone; returns the ratio of per-device
    throughputs, ``(t_one / n) / t_mesh``.  Each timing enqueues ``frames``
    renders back to back and forces them once, by one scalar read to the
    host, after a warm render."""
    params = TFParams.reference(mesh.home)

    def bench(m):
        def frame():
            rgb, a = render_tf_sharded(m, params, volume, entry_uv, direction, hit, max_samples)
            return torch.sum(rgb) + torch.sum(a)

        frame().item()
        t0 = time.perf_counter()
        s = torch.zeros((), device=m.home)
        for _ in range(frames):
            s = s + frame()
        if not np.isfinite(s.item()):  # the one forced read
            raise FloatingPointError(f"the probe's renders sum to {s.item()}")
        return (time.perf_counter() - t0) / frames

    t_mesh = bench(mesh)
    t_one = bench(make_mesh(1, devices=[mesh.home]))
    return (t_one / mesh.size) / t_mesh
