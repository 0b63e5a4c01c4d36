"""Several processes, one mesh: the port's multi-process layer on
``torch.distributed``.

Counterpart of ``volumerenderer_tpu/parallel/multihost.py`` (``initialize``,
``global_mesh``, ``host_local_bricks``, ``load_bricks_for_host``,
``measure_scaling_efficiency``).  In JAX one mesh spans every process and
XLA's collectives carry each ``shard_map`` across them.  Here every entry of
a ``DeviceMesh`` names the process that owns it (``DeviceMesh.ranks``), each
process marches only its own entries (``DeviceMesh.local_indices``), and the
sharded paths meet at one collective, :func:`gather`: every entry's tensors,
in mesh order, on every process.  In one process it copies each tensor to
the mesh's first device.  Because a gather
lists entries in mesh order, never by arrival, every fold and every sum runs
in the order of one process, and a render over several processes equals the
one-process render bit for bit.  The halo planes of
``bricks.extend_halos`` travel through it too.

The backend (:func:`choose_backend`): ``gloo`` for CPU devices and for ranks
that share a card (NCCL refuses two ranks on one device), ``nccl`` only when
every rank has cards of its own.  Gloo's collectives take CPU tensors, so
:func:`gather` stages CUDA tensors through pinned host buffers.

A process that calls no :func:`initialize` (or one with ``num_processes``
of 1) is process 0 of 1, and every mesh is its own.  To run one rank per
process: each calls ``initialize("host:port", n, rank)`` at startup, builds
its meshes with :func:`global_mesh`, and then calls the same sharded
functions in the same order, as JAX's processes run one program.
:func:`spawn` starts such ranks on one host.
"""
from __future__ import annotations

import dataclasses
import datetime
import socket
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..io.bricks import BrickGrid

__all__ = ["initialize", "process_index", "process_count", "local_devices", "choose_backend",
           "global_mesh", "gather", "host_local_bricks", "load_bricks_for_host",
           "measure_scaling_efficiency", "free_port", "spawn", "TIMEOUT"]

# every collective (and the rendezvous) of a group fails after this long, so
# a peer that died or hangs fails the run instead of hanging it
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass
class _Runtime:
    backend: str | None = None
    group: object = None          # the collectives' group; None: the default group
    devices: list | None = None   # this process's devices, given to initialize


_RUNTIME = _Runtime()


def process_index() -> int:
    """This process's rank; 0 without an initialized group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 without an initialized group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_devices() -> list[torch.device]:
    """This process's devices: those given to :func:`initialize`, else the
    host's CUDA cards (``sharding.default_devices``; raises without one)."""
    if _RUNTIME.devices is not None:
        return list(_RUNTIME.devices)
    from .sharding import default_devices

    return default_devices()


def _device_name(device) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def choose_backend(devices_by_rank, backend: str | None = None) -> str:
    """The backend for ranks whose devices are ``devices_by_rank``: one
    ``(host name, [device names])`` per rank.  ``None`` chooses ``"nccl"``
    when every rank's devices are CUDA cards that no other rank lists, and
    ``"gloo"`` otherwise.  An explicit ``"nccl"`` raises ``ValueError``
    where it cannot run (a CPU device, or a card two ranks share)."""
    owned = [{(host, d) for d in devs} for host, devs in devices_by_rank]
    cards_only = all(devs and all(d.startswith("cuda") for d in devs)
                     for _, devs in devices_by_rank)
    shared = sum(len(o) for o in owned) != len(set().union(*owned))
    own_cards = cards_only and not shared
    if backend is None:
        return "nccl" if own_cards else "gloo"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl" and not own_cards:
        raise ValueError(f"nccl needs every rank on cards of its own; the ranks' devices are "
                         f"{list(devices_by_rank)}: use gloo")
    return backend


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               local_devices=None) -> str | None:
    """Join the process group of ``num_processes`` ranks (a no-op for one
    process: returns None).

    Calls ``torch.distributed.init_process_group`` (gloo, ``init_method
    tcp://<coordinator_address>``, ``world_size``, ``rank``, ``timeout``
    :data:`TIMEOUT`); every rank then tells the others its host and its
    devices (``local_devices``, default the host's CUDA cards), and the
    backend of the collectives is chosen by :func:`choose_backend`: an
    NCCL group over the same ranks when it is ``"nccl"``.  Returns the
    backend chosen."""
    if num_processes is None or num_processes <= 1:
        return None
    if coordinator_address is None or process_id is None:
        raise ValueError("several processes need a coordinator_address ('host:port') and a "
                         "process_id")
    if local_devices is None:
        from .sharding import default_devices

        local_devices = default_devices()
    devices = [torch.device(d) for d in local_devices]
    if not devices:
        raise ValueError("a process needs at least one device")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id), timeout=TIMEOUT)
    everyone = [None] * int(num_processes)
    dist.all_gather_object(everyone, (socket.gethostname(), [_device_name(d) for d in devices]))
    try:
        chosen = choose_backend(everyone, backend)
    except ValueError:
        dist.destroy_process_group()
        raise
    group = None
    if chosen == "nccl":
        torch.cuda.set_device(devices[0])
        group = dist.new_group(backend="nccl", timeout=TIMEOUT)
    _RUNTIME.backend, _RUNTIME.group, _RUNTIME.devices = chosen, group, devices
    return chosen


def global_mesh(axis_names=("dp", "rays"), shape=None):
    """One ``DeviceMesh`` over every process's devices
    (:func:`local_devices`), ordered by rank, then by local index; the
    device lists are exchanged with ``all_gather_object``.  Default shape:
    all on the last axis, ``(1, total)`` for two axes."""
    from .sharding import DeviceMesh

    mine = [_device_name(d) for d in local_devices()]
    lists = [mine]
    if process_count() > 1:
        lists = [None] * process_count()
        dist.all_gather_object(lists, mine)
    flat = [d for devs in lists for d in devs]
    ranks = [r for r, devs in enumerate(lists) for _ in devs]
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (len(flat),)
    grid = np.empty(len(flat), dtype=object)
    for i, d in enumerate(flat):
        grid[i] = torch.device(d)
    return DeviceMesh(grid.reshape(shape), axis_names, np.asarray(ranks).reshape(shape))


def _pack_spec(item):
    dtypes = {t.dtype for t in item}
    if len(dtypes) != 1:
        raise ValueError(f"the tensors of one gathered entry share a dtype, got {dtypes}")
    return [tuple(t.shape) for t in item], str(dtypes.pop()).removeprefix("torch.")


def gather(mesh, local, indices=None) -> list[tuple]:
    """Every entry's tensors, in mesh order, on this process's ``mesh.home``.

    ``indices``: the flat indices of the entries taking part, in order
    (default: all).  ``local``: one tuple of tensors per entry among them
    that this process owns, in that order; every entry's tuple has the same
    shapes and one dtype.  Returns one tuple per index.  In one process
    each tensor is copied to the mesh's first device (``.to(mesh.first)``);
    over several, one ``all_gather`` of every process's entries packed in
    one buffer (pinned host memory for CUDA tensors under gloo) gives every
    process every entry."""
    indices = list(range(mesh.size)) if indices is None else [int(i) for i in indices]
    local = [tuple(item) for item in local]
    me = process_index()
    owners = [int(mesh.ranks.flat[i]) for i in indices]
    if len(local) != owners.count(me):
        raise ValueError(f"process {me} owns {owners.count(me)} of the gathered entries and "
                         f"passed {len(local)}")
    home = mesh.home
    if not mesh.multiprocess:
        return [tuple(t.to(home) for t in item) for item in local]
    world = process_count()
    counts = [owners.count(r) for r in range(world)]
    spec = _pack_spec(local[0]) if local else None
    if min(counts) == 0:  # a rank without entries learns their shapes
        specs = [None] * world
        dist.all_gather_object(specs, spec)
        spec = next(s for s in specs if s is not None)
    shapes, dtype = spec
    sizes = [int(np.prod(s)) for s in shapes]
    dtype = getattr(torch, dtype)
    staged = _RUNTIME.backend != "nccl"
    buf_device = torch.device("cpu") if staged else home
    pin = staged and home.type == "cuda"
    buf = torch.empty((max(counts), sum(sizes)), dtype=dtype, device=buf_device, pin_memory=pin)
    for j, item in enumerate(local):
        if _pack_spec(item) != spec:
            raise ValueError(f"gathered entries differ: {_pack_spec(item)} and {spec}")
        buf[j].copy_(torch.cat([t.reshape(-1) for t in item]))
    outs = [torch.empty(buf.shape, dtype=dtype, device=buf_device, pin_memory=pin)
            for _ in range(world)]
    dist.all_gather(outs, buf, group=_RUNTIME.group)
    taken = [0] * world
    result = []
    for r in owners:
        row = outs[r][taken[r]].to(home, non_blocking=True)
        taken[r] += 1
        result.append(tuple(part.reshape(shape)
                            for part, shape in zip(row.split(sizes), shapes)))
    return result


def host_local_bricks(grid: BrickGrid, z_shards: int) -> list[int]:
    """Brick numbers whose k-layer lies in this process's contiguous run of
    k-layers (per-host I/O: each process reads only its slice of the brick
    files): ``ceil(K / processes)`` layers per process, as the JAX function
    splits them.  ``z_shards`` is ignored, as in the JAX function; it stays
    for the same call."""
    I, J, Kb = grid.grid
    pid = process_index()
    nproc = max(process_count(), 1)
    per = -(-Kb // nproc)
    k_lo, k_hi = pid * per, min(Kb, (pid + 1) * per)
    return [b for b in range(grid.num_bricks()) if k_lo <= grid.brick_coords(b)[2] < k_hi]


def load_bricks_for_host(source, grid: BrickGrid, timestep: int):
    """This process's k-layer slab, (Kslab*bz, J*by, I*bx) uint8, assembled
    from its bricks alone (:func:`host_local_bricks`), or None when it has
    no brick."""
    bricks = host_local_bricks(grid, process_count())
    if not bricks:
        return None
    bx, by, bz = grid.brick_dims
    I, J, Kb = grid.grid
    ks = sorted({grid.brick_coords(b)[2] for b in bricks})
    out = np.zeros((len(ks) * bz, J * by, I * bx), dtype=np.uint8)
    k_base = ks[0]
    for b in bricks:
        i, j, k = grid.brick_coords(b)
        out[(k - k_base) * bz:(k - k_base + 1) * bz,
            j * by:(j + 1) * by, i * bx:(i + 1) * bx] = source(b, timestep)
    return out


def measure_scaling_efficiency(render_fn, mesh_sizes, *args, reps: int = 3):
    """Throughput per device across mesh sizes.

    ``render_fn(n_devices, *args)`` renders once and forces completion
    itself (a device sync or a host read).  One warm call per size, then the
    min of ``reps``.  Returns {n: (seconds, efficiency against the first
    size)}."""
    results = {}
    base = None
    for n in mesh_sizes:
        render_fn(n, *args)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            render_fn(n, *args)
            ts.append(time.perf_counter() - t0)
        dt = min(ts)
        per_dev = dt * n
        if base is None:
            base = per_dev
        results[n] = (dt, base / per_dev)
    return results


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now (bound to 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv, num_processes: int, timeout: float, env=None) -> list[str]:
    """Run ``num_processes`` ranks of the command ``argv`` on this host, each
    a fresh interpreter (no fork), with ``--coordinator 127.0.0.1:<port>
    --num-processes n --process-id r`` appended (a port free when it is
    chosen).  Waits for all; when one exits non-zero or ``timeout`` seconds
    pass, kills every rank and raises ``RuntimeError`` with the output of
    the rank that failed.  Returns each rank's output (stdout and stderr)."""
    address = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="ranks_") as logs:
        paths = [Path(logs) / f"rank{r}.log" for r in range(num_processes)]
        files = [open(p, "w") for p in paths]
        procs = []
        try:
            for r, f in enumerate(files):
                procs.append(subprocess.Popen(
                    [*argv, "--coordinator", address, "--num-processes", str(num_processes),
                     "--process-id", str(r)], stdout=f, stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout
            while (any(p.poll() is None for p in procs) and not any(p.returncode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in files:
                f.close()
        outputs = [p.read_text() for p in paths]
    codes = [p.returncode for p in procs]
    if any(codes):
        report = "\n".join(f"--- rank {r} (exit {c}) ---\n{out[-3000:]}"
                           for r, (c, out) in enumerate(zip(codes, outputs)))
        raise RuntimeError(f"the ranks ended with exit codes {codes} (a negative code: killed, "
                           f"after another rank failed or {timeout} s passed)\n{report}")
    return outputs
