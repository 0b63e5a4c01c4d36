"""The port's multi-process layer (``parallel/multihost.py``) on the CPU.

In-process: the per-host brick splits against the JAX package's (one
process, and 2 or 4 processes simulated by patching the process index and
count), ``host_local_bricks_3d``, the scaling probes, ``dryrun_multichip``,
the backend rule and the one-process ``gather``.

Across processes, the counterpart of tests/test_multihost_2proc.py: this file
runs itself as a worker (``python tests/test_torch_multihost.py <job> <dir>``;
the worker imports only the port) in 2 ranks over gloo, each with 4 CPU
devices.  Each rank reads only the bricks of its slab of a ``BrickGrid((32,
16, 8), (2, 2, 4))`` volume and places them on the 8-entry meshes; the ranks
then render z-sharded, brick-sharded and row-sharded and take fit steps.
Their outputs come back as ``.npy`` files and are held against the port's
one-process run on 8 CPU devices (bit for bit; the voxel step within B5's
bar) and, for the z-sharded render, against JAX's full-volume render (atol
1e-5, the JAX test's bar).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

from volumerenderer_tpu_torch import TFParams, as_normalized_volume  # noqa: E402
from volumerenderer_tpu_torch.entry import dryrun_multichip  # noqa: E402
from volumerenderer_tpu_torch.interop import rays_from_numpy  # noqa: E402
from volumerenderer_tpu_torch.io.bricks import (  # noqa: E402
    BrickGrid, load_bricks, synthetic_brick_source)
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume  # noqa: E402
from volumerenderer_tpu_torch.models import plan_compositing  # noqa: E402
from volumerenderer_tpu_torch.parallel import bricks, context, kernel_sharded as KS  # noqa: E402
from volumerenderer_tpu_torch.parallel import multihost as MH, sharding  # noqa: E402

CPU = torch.device("cpu")
GRID = BrickGrid(brick_dims=(32, 16, 8), grid=(2, 2, 4))   # (X, Y, Z) = (64, 32, 32)
TIMESTEP = 273
RANKS, PER_RANK = 2, 4
PLAIN_SAMPLES, SEG_SAMPLES = 16, 48
RANK_TIMEOUT_S = 120


def _fit_params():
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return TFParams(f32(0.45), f32(0.9), f32(0.05), f32([-0.8, 0.6, 0.3]), f32([0.9, 0.2, 0.4]))


def _target(shape, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).random(shape + (3,)).astype(np.float32))


def _layouts(meshes, volumes, full_u8, rays) -> dict:
    """Every layout's outputs as numpy arrays.  ``meshes``: z (8 shards),
    bricks ((4, 2, 1)), rows ((1, 8)), dp ((2, 4)); ``volumes``: the dimmed
    float32 and the uint8 volume, each as the z and the bricks layouts take
    it; ``full_u8``: the whole volume (the row-sharded paths replicate it)."""
    X, Y, Z = GRID.volume_dims()
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (X, Y, Z), SEG_SAMPLES)
    target = _target(plan.shape)
    ray_args = (rays.entry_uv, rays.direction, rays.hit)
    out = {}

    def put(name, tensors):
        for k, t in enumerate(tensors):
            out[f"{name}/{k}"] = t.detach().cpu().numpy()

    put("z_plain", context.render_zsharded(meshes["z"], volumes["z_dim"], *ray_args,
                                           max_samples=PLAIN_SAMPLES))
    put("bricks_plain", bricks.render_bricksharded(meshes["bricks"], volumes["bricks_dim"],
                                                   *ray_args, max_samples=PLAIN_SAMPLES))
    put("z_kernel", KS.render_zsharded_kernel(meshes["z"], plan, volumes["z_u8"]))
    put("bricks_kernel", KS.render_bricksharded_kernel(meshes["bricks"], plan,
                                                       volumes["bricks_u8"]))
    new, loss = KS.tf_fit_step_bricksharded(meshes["bricks"], plan, _fit_params(),
                                            volumes["bricks_u8"], target)
    put("bricks_tf", (*new, loss))
    put("rows_render", KS.render_planned_sharded(meshes["rows"], plan, full_u8))
    new, loss = KS.tf_fit_step_kernel(meshes["rows"], plan, _fit_params(), full_u8, target)
    put("rows_tf", (*new, loss))
    new, new_vol, loss = KS.voxel_fit_step_kernel(meshes["rows"], plan,
                                                  TFParams.reference(CPU), full_u8, target)
    put("rows_voxel", (*new, new_vol, loss))
    mirrored = [torch.stack([t, t.flip(1)]) for t in ray_args]
    new, loss = sharding.tf_fit_step(meshes["dp"], _fit_params(), as_normalized_volume(full_u8),
                                     *mirrored, _target((2,) + plan.shape), lr=1e-2,
                                     max_samples=PLAIN_SAMPLES)
    put("dp_tf", (*new, loss))
    return out


def _rays(directory: Path):
    return rays_from_numpy(*(np.load(directory / f"{k}.npy") for k in ("entry_uv", "direction",
                                                                        "hit")), device=CPU)


def _worker(argv) -> None:
    """One rank: ``layouts`` reads this rank's bricks, renders and steps
    every layout over the 2-process meshes and saves the outputs;
    ``fail`` has rank 1 raise while rank 0 waits in a gather."""
    ap = argparse.ArgumentParser()
    ap.add_argument("job", choices=("layouts", "fail"))
    ap.add_argument("out", type=Path)
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    backend = MH.initialize(args.coordinator, args.num_processes, args.process_id,
                            local_devices=[CPU] * PER_RANK)
    rank = MH.process_index()
    assert backend == "gloo" and MH.process_count() == RANKS and rank == args.process_id
    if args.job == "fail":
        if rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        mesh = MH.global_mesh(("z",))
        MH.gather(mesh, [(torch.zeros(4),)] * PER_RANK)
        return

    source = synthetic_brick_source(GRID)
    reads = []

    def counting(b, t):
        reads.append(b)
        return source(b, t)

    # per-host brick I/O: this rank's k-layers (the z mesh's slab)
    mine = MH.host_local_bricks(GRID, RANKS * PER_RANK)
    slab = MH.load_bricks_for_host(counting, GRID, TIMESTEP)
    z_reads = sorted(reads)
    zmesh = MH.global_mesh(("z",))
    z0 = slab.shape[0] * rank
    volumes = {"z_dim": bricks.shard_volume(zmesh, as_normalized_volume(slab, CPU) * 0.25,
                                            offset=(z0, 0, 0)),
               "z_u8": bricks.shard_volume(zmesh, torch.from_numpy(slab), offset=(z0, 0, 0))}

    # the bricks of this rank's (4, 2, 1) shards, by host_local_bricks_3d
    bmesh = MH.global_mesh(("bz", "by", "bx"), shape=(4, 2, 1))
    reads.clear()
    bx, by, bz = GRID.brick_dims
    shard_idx = [np.unravel_index(i, (4, 2, 1)) for i in bmesh.local_indices()]
    wanted = sorted({b for idx in shard_idx
                     for b in bricks.host_local_bricks_3d(GRID, (4, 2, 1), idx)})
    k_lo = min(GRID.brick_coords(b)[2] for b in wanted)
    block = np.zeros_like(slab)
    for b in wanted:
        i, j, k = GRID.brick_coords(b)
        block[(k - k_lo) * bz:(k - k_lo + 1) * bz, j * by:(j + 1) * by,
              i * bx:(i + 1) * bx] = counting(b, TIMESTEP)
    b_reads = sorted(reads)
    offset = (k_lo * bz, 0, 0)
    volumes["bricks_dim"] = bricks.shard_volume(bmesh, as_normalized_volume(block, CPU) * 0.25,
                                                offset=offset)
    volumes["bricks_u8"] = bricks.shard_volume(bmesh, torch.from_numpy(block), offset=offset)

    # the row-sharded paths replicate the volume: gather the z slabs
    full_u8 = torch.cat([b for (b,) in MH.gather(
        zmesh, [(volumes["z_u8"].bricks[i, 0, 0],) for i in zmesh.local_indices()])])
    meshes = {"z": zmesh, "bricks": bmesh, "rows": MH.global_mesh(),
              "dp": MH.global_mesh(shape=(2, RANKS * PER_RANK // 2))}
    rays = _rays(args.out)
    out = _layouts(meshes, volumes, full_u8, rays)
    out["reads/z"] = np.asarray(z_reads)
    out["reads/z_expected"] = np.asarray(sorted(mine))
    out["reads/bricks"] = np.asarray(b_reads)
    out["reads/bricks_expected"] = np.asarray(wanted)
    out["ranks/z"] = zmesh.ranks
    out["ranks/bricks"] = bmesh.ranks
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, GRID.volume_dims(),
                            SEG_SAMPLES)
    out["probe/kernel"] = np.asarray(KS.scaling_probe_kernel(meshes["rows"], plan, full_u8,
                                                             frames=2))
    out["probe/tf"] = np.asarray(sharding.scaling_efficiency_probe(
        meshes["rows"], as_normalized_volume(full_u8), rays.entry_uv, rays.direction, rays.hit,
        max_samples=PLAIN_SAMPLES, frames=2))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "volumerenderer_tpu"))
    assert not leaked, leaked
    np.savez(args.out / f"rank{rank}.npz", **out)
    print(f"rank {rank} OK", flush=True)


def _spawn(job: str, directory: Path) -> list[str]:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return MH.spawn([sys.executable, "-u", __file__, job, str(directory)], RANKS,
                    timeout=RANK_TIMEOUT_S, env=env)


# ---- in-process tests ------------------------------------------------------

@pytest.mark.parametrize("grid", [GRID, BrickGrid(brick_dims=(8, 8, 4), grid=(3, 2, 5))])
def test_host_local_bricks_one_process_matches_jax(grid):
    from volumerenderer_tpu.io.bricks import BrickGrid as JGrid
    from volumerenderer_tpu.io.bricks import synthetic_brick_source as jsource
    from volumerenderer_tpu.parallel import multihost as JMH

    jgrid = JGrid(brick_dims=grid.brick_dims, grid=grid.grid)
    assert MH.host_local_bricks(grid, 4) == JMH.host_local_bricks(jgrid, 4) \
        == list(range(grid.num_bricks()))
    slab = MH.load_bricks_for_host(synthetic_brick_source(grid), grid, TIMESTEP)
    np.testing.assert_array_equal(slab, JMH.load_bricks_for_host(jsource(jgrid), jgrid, TIMESTEP))
    np.testing.assert_array_equal(slab, load_bricks(synthetic_brick_source(grid), grid,
                                                    grid.num_bricks(), *grid.grid, TIMESTEP))


@pytest.mark.parametrize("nproc", [2, 4])
@pytest.mark.parametrize("grid", [GRID, BrickGrid(brick_dims=(8, 8, 4), grid=(3, 2, 5))])
def test_host_local_bricks_simulated_processes(monkeypatch, nproc, grid):
    """Each simulated process gets the bricks of its contiguous k-layers,
    brute force and as JAX's function gives them; the slabs stack into the
    whole volume, and each brick is read by one process only."""
    import jax

    from volumerenderer_tpu.io.bricks import BrickGrid as JGrid
    from volumerenderer_tpu.parallel import multihost as JMH

    jgrid = JGrid(brick_dims=grid.brick_dims, grid=grid.grid)
    source = synthetic_brick_source(grid)
    Kb = grid.grid[2]
    per = -(-Kb // nproc)
    seen, slabs = [], []
    for pid in range(nproc):
        for mod, name, value in ((MH, "process_index", pid), (MH, "process_count", nproc),
                                 (jax, "process_index", pid), (jax, "process_count", nproc)):
            monkeypatch.setattr(mod, name, lambda v=value: v)
        mine = MH.host_local_bricks(grid, 8)
        brute = [b for b in range(grid.num_bricks())
                 if pid * per <= grid.brick_coords(b)[2] < (pid + 1) * per]
        assert mine == brute == JMH.host_local_bricks(jgrid, 8)
        reads = []
        slab = MH.load_bricks_for_host(lambda b, t: reads.append(b) or source(b, t), grid,
                                       TIMESTEP)
        assert sorted(reads) == mine
        if mine:
            slabs.append(slab)
        else:
            assert slab is None
        seen += mine
    assert sorted(seen) == list(range(grid.num_bricks()))
    full = load_bricks(source, grid, grid.num_bricks(), *grid.grid, TIMESTEP)
    np.testing.assert_array_equal(np.concatenate(slabs), full)


@pytest.mark.parametrize("grid,mesh_shape", [
    (BrickGrid(brick_dims=(16, 16, 16), grid=(8, 8, 4)), (2, 2, 2)),
    (GRID, (4, 2, 1)),
    (BrickGrid(brick_dims=(8, 8, 8), grid=(3, 4, 2)), (4, 2, 1)),   # uneven: shared bricks
    (BrickGrid(brick_dims=(128, 128, 128), grid=(2, 2, 2)), (2, 2, 1)),
])
def test_host_local_bricks_3d_matches_jax(grid, mesh_shape):
    from volumerenderer_tpu.io.bricks import BrickGrid as JGrid
    from volumerenderer_tpu.parallel.bricks import host_local_bricks_3d as jlocal

    jgrid = JGrid(brick_dims=grid.brick_dims, grid=grid.grid)
    seen = []
    for idx in np.ndindex(*mesh_shape):
        mine = bricks.host_local_bricks_3d(grid, mesh_shape, idx)
        assert mine == jlocal(jgrid, mesh_shape, idx)
        seen += mine
    assert sorted(set(seen)) == list(range(grid.num_bricks()))
    bx, by, bz = grid.brick_dims
    X, Y, Z = grid.volume_dims()
    even = all(n % s == 0 for n, s in zip((Z // bz, Y // by, X // bx), mesh_shape))
    assert (sorted(seen) == list(range(grid.num_bricks()))) == even


def test_host_local_bricks_3d_refuses_a_split_that_does_not_divide():
    with pytest.raises(ValueError, match="does not split"):
        bricks.host_local_bricks_3d(GRID, (3, 1, 1), (0, 0, 0))


def _small_scene():
    vol = as_normalized_volume(turbulence_volume((16, 16, 16), seed=6), device=CPU)
    rays = rays_from_numpy(*(np.asarray(a) for a in _jax_rays(16, 8)), device=CPU)
    return vol, rays


def _jax_rays(width, height):
    import volumerenderer_tpu as J

    r = J.generate_rays(J.Camera(width=width, height=height))
    return np.asarray(r.entry_uv), np.asarray(r.direction), np.asarray(r.hit)


def test_measure_scaling_efficiency_on_a_cpu_mesh():
    vol, rays = _small_scene()
    params = TFParams.reference(CPU)
    meshes = {n: sharding.make_mesh(devices=[CPU] * n) for n in (1, 2, 4)}

    def render_fn(n):
        rgb, a = sharding.render_tf_sharded(meshes[n], params, vol, rays.entry_uv,
                                            rays.direction, rays.hit, max_samples=16)
        return float(rgb.sum() + a.sum())

    res = MH.measure_scaling_efficiency(render_fn, (1, 2, 4), reps=2)
    assert set(res) == {1, 2, 4} and res[1][1] == 1.0
    for dt, eff in res.values():
        assert dt > 0 and np.isfinite(eff) and eff > 0


def test_scaling_efficiency_probe_on_a_cpu_mesh():
    vol, rays = _small_scene()
    eff = sharding.scaling_efficiency_probe(sharding.make_mesh(devices=[CPU] * 4), vol,
                                            rays.entry_uv, rays.direction, rays.hit,
                                            max_samples=16, frames=2)
    assert np.isfinite(eff) and eff > 0


def test_scaling_probe_kernel_on_a_cpu_mesh():
    vol, rays = _small_scene()
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit, (16, 16, 16), 16)
    eff = KS.scaling_probe_kernel(sharding.DeviceMesh([CPU] * 4, ("rays",)), plan, vol, frames=2)
    assert np.isfinite(eff) and eff > 0


def test_dryrun_multichip_on_eight_cpu_devices():
    dryrun_multichip(8, devices=[CPU] * 8)


def test_initialize_with_one_process_is_a_no_op():
    assert MH.initialize("127.0.0.1:1", num_processes=1, process_id=0) is None
    assert MH.initialize() is None
    assert not torch.distributed.is_initialized()
    assert (MH.process_index(), MH.process_count()) == (0, 1)
    mesh = bricks.make_brick_mesh((2, 2, 1), devices=[CPU] * 4)
    assert not mesh.multiprocess and mesh.local_indices() == [0, 1, 2, 3]
    assert mesh.home == mesh.first
    with pytest.raises(RuntimeError, match="no CUDA device"):  # one process: the host's cards
        MH.global_mesh()


@pytest.mark.parametrize("ranks,backend,want", [
    ([("h", ["cpu"]), ("h", ["cpu"])], None, "gloo"),
    ([("h", ["cuda:0"]), ("h", ["cuda:0"])], None, "gloo"),          # two ranks, one card
    ([("h", ["cuda:0", "cuda:0"]), ("h", ["cuda:0"])], None, "gloo"),
    ([("h", ["cuda:0"]), ("h", ["cuda:1"])], None, "nccl"),
    ([("a", ["cuda:0"]), ("b", ["cuda:0"])], None, "nccl"),          # two hosts
    ([("h", ["cuda:0", "cuda:0"]), ("h", ["cuda:1"])], None, "nccl"),
    ([("h", ["cuda:0"]), ("h", ["cuda:1"])], "gloo", "gloo"),
    ([("h", ["cuda:0"]), ("h", ["cuda:0"])], "nccl", ValueError),
    ([("h", ["cpu"]), ("h", ["cpu"])], "nccl", ValueError),
    ([("h", ["cuda:0"]), ("h", ["cpu"])], "nccl", ValueError),
    ([("h", ["cuda:0"])], "mpi", ValueError),
])
def test_choose_backend(ranks, backend, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            MH.choose_backend(ranks, backend)
    else:
        assert MH.choose_backend(ranks, backend) == want


def test_gather_in_one_process_is_the_copy_to_the_first_device():
    mesh = context.make_z_mesh(3, devices=[CPU] * 3)
    local = [(torch.full((2, 3), float(i)), torch.arange(4.0) + i) for i in range(3)]
    got = MH.gather(mesh, local)
    assert len(got) == 3 and all(torch.equal(g[0], t[0]) and torch.equal(g[1], t[1])
                                 for g, t in zip(got, local))
    with pytest.raises(ValueError, match="owns 3"):
        MH.gather(mesh, local[:2])


def test_shard_volume_takes_a_process_part_at_its_offset():
    vol = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    mesh = bricks.make_brick_mesh((2, 2, 1), devices=[CPU] * 4)
    whole = bricks.shard_volume(mesh, vol)
    part = bricks.shard_volume(mesh, vol, offset=(0, 0, 0))
    assert part.shape == whole.shape == (8, 4, 6)
    assert all(torch.equal(a, b) for a, b in zip(part.bricks.flat, whole.bricks.flat))
    with pytest.raises(ValueError, match="offset"):
        bricks.shard_volume(mesh, vol, offset=(4, 0, 0))
    # a process owning the second z half only: its part and its offset
    half = sharding.DeviceMesh(mesh.devices, mesh.axis_names,
                               ranks=np.array([[[1], [1]], [[0], [0]]]))
    sv = bricks.shard_volume(half, vol[4:], offset=(4, 0, 0))
    assert sv.shape == (8, 4, 6) and sv.bricks[0, 0, 0] is None and sv.bricks[0, 1, 0] is None
    assert torch.equal(sv.bricks[1, 1, 0], vol[4:, 2:])
    assert half.multiprocess and half.local_indices() == [2, 3] and half.home == CPU


# ---- across two processes -------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank run (ranks' outputs by rank) and the one-process run of
    the same layouts on 8 CPU devices, on the JAX package's rays."""
    directory = tmp_path_factory.mktemp("ranks")
    for name, arr in zip(("entry_uv", "direction", "hit"), _jax_rays(32, 16)):
        np.save(directory / f"{name}.npy", arr)
    t0 = time.perf_counter()
    logs = _spawn("layouts", directory)
    seconds = time.perf_counter() - t0
    ranks = [dict(np.load(directory / f"rank{r}.npz")) for r in range(RANKS)]

    cpu8 = [CPU] * (RANKS * PER_RANK)
    full_u8 = torch.from_numpy(load_bricks(synthetic_brick_source(GRID), GRID, GRID.num_bricks(),
                                           *GRID.grid, TIMESTEP))
    dim = as_normalized_volume(full_u8) * 0.25
    meshes = {"z": context.make_z_mesh(8, devices=cpu8),
              "bricks": bricks.make_brick_mesh((4, 2, 1), devices=cpu8),
              "rows": sharding.make_mesh(devices=cpu8),
              "dp": sharding.make_mesh(8, dp=2, devices=cpu8)}
    volumes = {"z_dim": dim, "z_u8": full_u8, "bricks_dim": dim, "bricks_u8": full_u8}
    one = _layouts(meshes, volumes, full_u8, _rays(directory))
    return {"ranks": ranks, "one": one, "logs": logs, "seconds": seconds, "dir": directory,
            "full_u8": full_u8}


def test_two_ranks_each_read_only_their_bricks(two_ranks):
    z_all, b_all = [], []
    for r, out in enumerate(two_ranks["ranks"]):
        assert f"rank {r} OK" in two_ranks["logs"][r]
        np.testing.assert_array_equal(out["reads/z"], out["reads/z_expected"])
        np.testing.assert_array_equal(out["reads/bricks"], out["reads/bricks_expected"])
        assert len(out["reads/z"]) == GRID.num_bricks() // RANKS
        np.testing.assert_array_equal(out["ranks/z"], [0] * 4 + [1] * 4)
        z_all += out["reads/z"].tolist()
        b_all += out["reads/bricks"].tolist()
    assert sorted(z_all) == sorted(b_all) == list(range(GRID.num_bricks()))
    assert two_ranks["seconds"] < RANK_TIMEOUT_S


def test_two_rank_zsharded_render_matches_jax(two_ranks):
    """JAX's full-volume render without early-out, dimmed by 0.25, as
    tests/test_multihost_2proc.py holds its two processes."""
    import volumerenderer_tpu as J
    from volumerenderer_tpu.ops.raycast import render_compositing

    full = J.as_normalized_volume(two_ranks["full_u8"].numpy()) * 0.25
    rays = [np.load(two_ranks["dir"] / f"{k}.npy") for k in ("entry_uv", "direction", "hit")]
    rgb_j, a_j = render_compositing(full, *rays, max_samples=PLAIN_SAMPLES, early_exit=False)
    for out in two_ranks["ranks"]:
        assert float(out["z_plain/1"].max()) > 0.2
        np.testing.assert_allclose(out["z_plain/0"], np.asarray(rgb_j), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["z_plain/1"], np.asarray(a_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", ["z_plain", "bricks_plain", "z_kernel", "bricks_kernel",
                                    "bricks_tf", "rows_render", "rows_tf"])
def test_two_rank_layout_equals_one_process(two_ranks, layout):
    """Every rank returns the one-process result, bit for bit: renders,
    losses and parameters."""
    keys = sorted(k for k in two_ranks["one"] if k.startswith(layout + "/"))
    assert keys
    for out in two_ranks["ranks"]:
        for k in keys:
            np.testing.assert_array_equal(out[k], two_ranks["one"][k], err_msg=k)


def test_two_rank_voxel_step_within_b5s_bar(two_ranks):
    """The TF parameters and the loss bit for bit; the volume within 2e-5 of
    the step's largest voxel update (B5's float atomics)."""
    one = two_ranks["one"]
    n_params = len(TFParams._fields)
    vol_key, loss_key = f"rows_voxel/{n_params}", f"rows_voxel/{n_params + 1}"
    before = as_normalized_volume(two_ranks["full_u8"]).numpy()
    bar = 2e-5 * float(np.abs(one[vol_key] - before).max())
    assert bar > 0
    for out in two_ranks["ranks"]:
        for k in [f"rows_voxel/{i}" for i in range(n_params)] + [loss_key]:
            np.testing.assert_array_equal(out[k], one[k], err_msg=k)
        assert float(np.abs(out[vol_key] - one[vol_key]).max()) <= bar


def test_two_rank_dp_fit_step_sums_in_mesh_order(two_ranks):
    """The (dp, rays) plain fit step over two processes differentiates each
    shard alone and sums in mesh order; one process backpropagates through
    the summed copies, so the two agree to rounding."""
    one = two_ranks["one"]
    keys = sorted(k for k in one if k.startswith("dp_tf/"))
    for out in two_ranks["ranks"]:
        for k in keys:
            np.testing.assert_allclose(out[k], one[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_two_rank_scaling_probes_are_finite(two_ranks):
    for out in two_ranks["ranks"]:
        for k in ("probe/kernel", "probe/tf"):
            assert np.isfinite(out[k]) and float(out[k]) > 0


def test_a_failing_rank_fails_the_run_within_its_timeout(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        _spawn("fail", tmp_path)
    assert time.perf_counter() - t0 < RANK_TIMEOUT_S


if __name__ == "__main__":
    _worker(sys.argv[1:])
