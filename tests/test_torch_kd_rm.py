"""The upstream's own pipeline on the port, at small sizes on the CPU: the
kd-tree built by ``build_device`` (tolerance 1, 2 epochs, as the
benchmark's ``rm256_kdtree_1600x1200`` builds 2048x2048x512 on the card),
its full level cut, and its pooled compositing render.

The tree is held code for code, chain for chain, Δ for Δ and cut byte for
byte against the benchmark's plain codec (``benchmark/vrbench/
reference_kd.py``, which imports nothing of the program), whole and with
every pass cut into small chunks; the seeds the build records, and the
reference's own plain seed loop, against the sequential running mean
(``kdtree._seed_level_py``); the tree against the
JAX package's ``kdtree.build``; the pooled plan's frames against the plain
render (``benchmark/vrbench/reference.py``) of the reference's cut; and a
cut decodes once (``vr.kd.decode`` spans) for the block maxima and the
slab pool.  The ``cuda`` tests build 512x512x256 (2^26 leaves) on the card
against the reference and run the compiled seed helper on bytes at a
shift, and on 2^31 nodes against the reference's plain loop."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volumerenderer_tpu_torch import Camera, generate_rays
from volumerenderer_tpu_torch.codecs import device as TD
from volumerenderer_tpu_torch.codecs import device_build as TDB
from volumerenderer_tpu_torch.codecs import kdtree as TK
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu_torch.models import CompressedRenderer

BENCH_DIR = Path(__file__).resolve().parent.parent / "benchmark"
sys.path.insert(0, str(BENCH_DIR))
from vrbench import reference as R  # noqa: E402
from vrbench import reference_kd as RKD  # noqa: E402

TOLERANCE, EPOCHS = 1, 2
SHAPES = {"64x32x32": (32, 32, 64), "32x32x16": (16, 32, 32)}  # X x Y x Z -> (Z, Y, X)


def _volume(name):
    return turbulence_volume(SHAPES[name], seed=23)


def _chunked(monkeypatch):
    """Every pass in chunks of a few nodes: the build's levels, its leaf
    order, the packing of the chains, the decode's groups and the
    reference's levels."""
    monkeypatch.setattr(TDB, "ENCODE_CHUNK", 256)
    monkeypatch.setattr(TD, "LEAF_ORDER_CHUNK_BITS", 6)
    monkeypatch.setattr(TD, "PACK_ROWS", 100)
    monkeypatch.setattr(TD, "CHUNKED_DECODE_MIN_DEPTH", 4)
    monkeypatch.setattr(TD, "CHUNK_LEAF_BITS", 5)
    monkeypatch.setattr(TD, "CHUNK_GROUP_LEAF_BITS", 7)
    monkeypatch.setattr(RKD, "CHUNK", 512)


def _check(vol, tree, device="cpu"):
    """(reference_kd's numbers, the port's cut, the reference's cut)."""
    dtree, spec = TD.to_device(tree, device)
    cut = TD.level_cut_device(dtree, spec)
    numbers, ref_cut = RKD.check_tree(torch.as_tensor(vol, device=device), TOLERANCE, EPOCHS,
                                      tree.seeds, spec["max_depth"], tree.distance_map,
                                      dtree.packed_levels, dtree.packed_chains, cut)
    return numbers, cut, ref_cut


@pytest.mark.parametrize("chunks", ["whole", "chunked"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_build_device_equals_the_reference(name, chunks, monkeypatch):
    if chunks == "chunked":
        _chunked(monkeypatch)
    vol = _volume(name)
    tree = TDB.build_device(vol, tolerance=TOLERANCE, max_epochs=EPOCHS, device="cpu")
    assert isinstance(tree.chain_codes, torch.Tensor)
    assert int((tree.chain_codes[:, 0] == 1).sum() + (tree.chain_codes[:, 0] == 2).sum()) > 0
    numbers, cut, ref_cut = _check(vol, tree)
    assert numbers == {"delta_bad_levels": 0.0, "code_bad": 0.0, "cut_bad_voxels": 0.0}
    assert torch.equal(cut, ref_cut)
    np.testing.assert_array_equal(ref_cut.numpy(), TK.level_cut(TDB.to_host(tree)))


def test_the_reference_counts_what_differs():
    vol = _volume("32x32x16")
    tree = TDB.build_device(vol, tolerance=TOLERANCE, max_epochs=EPOCHS, device="cpu")
    D = tree.orig_depth
    tree.distance_map[D] += 1
    leaf = int(torch.nonzero(tree.chain_codes[:, 0] == 1)[0, 0])
    tree.chain_codes[leaf, 0] = 2
    tree.level_codes[D - 3][:5] = 3 - tree.level_codes[D - 3][:5].clamp(max=2)
    numbers, _, _ = _check(vol, tree)
    assert numbers["delta_bad_levels"] == 1 and numbers["code_bad"] >= 6
    assert numbers["cut_bad_voxels"] > 0


@pytest.mark.parametrize("level", [0, 5])
def test_the_reference_counts_a_recorded_seed_that_differs(level):
    """A recorded seed one off is a bad level, whether or not its fit ends
    at another Δ."""
    vol = _volume("32x32x16")
    tree = TDB.build_device(vol, tolerance=TOLERANCE, max_epochs=EPOCHS, device="cpu")
    tree.seeds[level] += 1
    numbers, _, _ = _check(vol, tree)
    assert numbers["delta_bad_levels"] >= 1


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("spread", [0, 2, 60])
def test_the_references_seed_loop_is_the_running_mean(shift, spread):
    rng = np.random.default_rng(40 + spread)
    parent = rng.integers(0, 256, 6000 >> shift).astype(np.uint8)
    est = np.repeat(parent, 1 << shift)[:5999]
    truth = np.clip(est.astype(int) + rng.integers(-spread, spread + 1, 5999), 0,
                    255).astype(np.uint8)
    want = TK._seed_level_py(truth, est)
    assert RKD.seed_sums(truth, parent if shift else est, shift) == want
    assert RKD.seed_level(truth, parent if shift else est, shift) == TK.seed_level(truth, est)


def _level_recons(vol, tree):
    """Each level's truth and recon, encoded at the tree's Δ."""
    sched = RKD.split_schedule(*tree.dims)
    levels = RKD.pyramid(RKD.to_leaves(torch.from_numpy(vol), sched), tree.orig_depth)
    out, recon = [], torch.zeros(1, dtype=torch.int32)
    for d, truth in enumerate(levels):
        parent = recon.repeat_interleave(2)[:truth.shape[0]]
        _, recon, _ = RKD.encode(truth.to(torch.int32), parent, int(tree.distance_map[d]))
        out.append((truth.numpy(), parent.numpy()))
    return out


@pytest.mark.parametrize("name", list(SHAPES))
def test_recorded_seeds_are_the_running_mean(name):
    vol = _volume(name)
    tree = TDB.build_device(vol, tolerance=TOLERANCE, max_epochs=EPOCHS, device="cpu")
    assert tree.seeds.shape == (tree.orig_depth + 1,)
    for d, (truth, parent) in enumerate(_level_recons(vol, tree)):
        s, c = TK._seed_level_py(truth, parent)
        assert tree.seeds[d] == (float(np.floor(s / c + 0.5)) if c > 0 else 0.0), d


def test_seed_level_reads_the_parent_level_at_a_shift():
    rng = np.random.default_rng(3)
    parent = rng.integers(0, 256, 600).astype(np.uint8)
    truth = np.clip(np.repeat(parent, 2)[:1199].astype(int) + rng.integers(-3, 4, 1199), 0,
                    255).astype(np.uint8)
    want = TK.seed_level(truth, np.repeat(parent, 2)[:1199].astype(np.int32))
    assert TK.seed_level(truth, parent, shift=1) == want


@pytest.mark.parametrize("name", list(SHAPES))
def test_tree_equals_jax_kdtree_build(name):
    from volumerenderer_tpu.codecs import kdtree as JK

    vol = _volume(name)
    got = TDB.to_host(TDB.build_device(vol, tolerance=TOLERANCE, max_epochs=EPOCHS,
                                       device="cpu"))
    want = JK.build(vol, tolerance=TOLERANCE, max_epochs=EPOCHS)
    np.testing.assert_array_equal(got.distance_map, np.asarray(want.distance_map))
    assert len(got.level_codes) == len(want.level_codes)
    for a, b in zip(got.level_codes, want.level_codes):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got.chain_codes, np.asarray(want.chain_codes))
    np.testing.assert_array_equal(got.leaf_recon, np.asarray(want.leaf_recon))
    assert got.num_active_nodes == want.num_active_nodes


def _cameras(n):
    return [R.orbit_camera(2.0 * i, 20, 16, 50.0) for i in range(n)]


def _program_rays(cam):
    return generate_rays(Camera(position=cam.position, front=cam.front, up=cam.up,
                                fov_y_degrees=cam.fov_y_degrees, width=cam.width,
                                height=cam.height), device="cpu")


@pytest.mark.parametrize("name", list(SHAPES))
def test_pooled_plan_matches_the_reference_render(name):
    vol = _volume(name)
    tree = TDB.build_device(vol, tolerance=TOLERANCE, max_epochs=EPOCHS, device="cpu")
    _, _, ref_cut = _check(vol, tree)
    renderer = CompressedRenderer(tree, "cpu")
    for cam in _cameras(3):
        rgb, alpha = renderer.make_plan(_program_rays(cam), pooled=True)()
        rgb_ref, alpha_ref, _ = R.composite(ref_cut, R.generate_rays(cam, "cpu"))
        assert float((rgb - rgb_ref).abs().max()) <= 1e-4
        assert float((alpha - alpha_ref).abs().max()) <= 1e-4


def test_a_device_tree_is_packed_where_it_lies_and_not_kept():
    vol = _volume("32x32x16")
    tree = TDB.build_device(vol, tolerance=TOLERANCE, max_epochs=EPOCHS, device="cpu")
    got, spec = TD.to_device(tree, "cpu")
    want, spec_host = TD.to_device(TDB.to_host(tree), "cpu")
    assert spec == spec_host
    assert all(torch.equal(a, b) for a, b in zip(got.packed_levels, want.packed_levels))
    assert torch.equal(got.packed_chains, want.packed_chains)
    renderer = CompressedRenderer(tree, "cpu")
    assert renderer.tree.chain_codes is None and renderer.tree.level_codes is None
    assert renderer.tree.num_active_nodes == tree.num_active_nodes
    host = CompressedRenderer(TK.build(vol, tolerance=TOLERANCE, max_epochs=EPOCHS), "cpu")
    assert host.tree.chain_codes is None and host.tree.num_active_nodes == tree.num_active_nodes


def _decodes(fn) -> int:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name == "vr.kd.decode" for e in prof.events())


@pytest.mark.parametrize("regime", ["tree_scalars", "chunked_cut"])
def test_one_decode_per_cut(regime, monkeypatch):
    """The pooled plans of two cameras: one decode gives the block maxima
    and the pool; the dense plan's cut and maxima: one decode."""
    if regime == "chunked_cut":
        monkeypatch.setattr(TD, "CHUNKED_DECODE_MIN_DEPTH", 4)
        monkeypatch.setattr(TD, "CHUNK_LEAF_BITS", 6)
    vol = _volume("32x32x16")
    tree = TK.build(vol, tolerance=TOLERANCE, max_epochs=EPOCHS)
    renderer = CompressedRenderer(tree, "cpu")
    rays = [_program_rays(c) for c in _cameras(2)]
    assert _decodes(lambda: [renderer.make_plan(r, pooled=True) for r in rays]) == 1
    assert _decodes(lambda: renderer.mip8_at()) == 0
    dense = CompressedRenderer(tree, "cpu")
    assert _decodes(lambda: [dense.make_plan(r) for r in rays] + [dense.mip8_at()]) == 1
    assert torch.equal(renderer.mip8_at(), TD.tree_occupancy_mip8(renderer.dtree, renderer.spec))


def test_build_spans_count_the_fits_evaluations(monkeypatch):
    evaluations = []
    sq_err_sum = TDB._sq_err_sum
    monkeypatch.setattr(TDB, "_sq_err_sum", lambda *a: evaluations.append(a[-1]) or
                        sq_err_sum(*a))
    vol = sphere_volume((16, 16, 16))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tree = TDB.build_device(vol, tolerance=TOLERANCE, max_epochs=EPOCHS, device="cpu")
    events = [e for e in prof.events() if e.name.startswith("vr.kd.")]
    count = {n: sum(e.name == n for e in events) for n in ("vr.kd.build", "vr.kd.seed",
                                                           "vr.kd.encode")}
    D = tree.orig_depth
    assert count == {"vr.kd.build": 1, "vr.kd.seed": D + 1,
                     "vr.kd.encode": len(evaluations) + D + 1}
    (build,) = [e for e in events if e.name == "vr.kd.build"]
    assert all(build.time_range.start <= e.time_range.start and
               e.time_range.end <= build.time_range.end for e in events)


@pytest.mark.parametrize("chunk_bits", [0, 3, 9, 30])
def test_volume_leaf_order_in_chunks(chunk_bits):
    vol = turbulence_volume((8, 16, 32), seed=2)
    sched = TK.split_schedule(32, 16, 8)
    got = TD.volume_leaf_order(torch.from_numpy(vol), sched, chunk_bits)
    np.testing.assert_array_equal(got.numpy(), TK.volume_to_leaves(vol, sched))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the build at 2^26 leaves and the compiled seed "
                    "helper run on the chip")
    return torch.device("cuda")


@pytest.mark.cuda
def test_build_at_2_26_leaves_on_the_card_equals_the_reference(cuda_device):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)
    smooth = torch.nn.functional.interpolate(
        torch.rand((1, 1, 16, 32, 32), generator=gen, device=cuda_device),
        size=(256, 512, 512), mode="trilinear")[0, 0]
    noise = torch.randint(-2, 3, smooth.shape, generator=gen, device=cuda_device)
    vol = torch.clamp((smooth * 255).to(torch.int16) + noise, 0, 255).to(torch.uint8)
    tree = TDB.build_device(vol, tolerance=TOLERANCE, max_epochs=EPOCHS, device=cuda_device)
    assert tree.orig_depth == 26 and tree.chain_codes.is_cuda
    numbers, cut, ref_cut = _check(vol, tree, cuda_device)
    assert numbers == {"delta_bad_levels": 0.0, "code_bad": 0.0, "cut_bad_voxels": 0.0}
    assert torch.equal(cut, ref_cut)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [1, 3, 40])
def test_compiled_seed_helper_reads_bytes_at_a_shift(cuda_device, spread):
    """The helper against the Python loop on 2^22 nodes (its blocks grow to
    2^14 nodes and its band narrows as the count grows), the parent level
    as bytes at shift 1 and as int32 a node."""
    rng = np.random.default_rng(12 + spread)
    parent = rng.integers(0, 256, 1 << 21).astype(np.uint8)
    truth = np.clip(np.repeat(parent, 2).astype(int)
                    + rng.integers(-spread, spread + 1, 1 << 22), 0, 255).astype(np.uint8)
    want = TK._seed_level_py(truth, np.repeat(parent, 2))
    assert TK._seed_level_native(truth, parent, shift=1) == want
    assert TK._seed_level_native(truth, np.repeat(parent, 2).astype(np.int32)) == want
    assert want[1] > 0


@pytest.mark.cuda
def test_compiled_seed_helper_equals_the_plain_loop_on_2_31_nodes(cuda_device):
    """The helper against the benchmark's plain sequential loop on a level
    the size of the 2048x2048x512 tree's leaves, mostly one step from the
    parent, so that the count passes 2^30 and the helper's blocks reach
    their largest, 2^22 nodes."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(31)
    parent = torch.randint(0, 256, (1 << 30,), generator=gen, device=cuda_device,
                           dtype=torch.uint8)
    step = torch.randint(-2, 3, (1 << 31,), generator=gen, device=cuda_device,
                         dtype=torch.int8)
    truth = torch.clamp(parent.repeat_interleave(2).to(torch.int16) + step, 0, 255)
    truth, parent = truth.to(torch.uint8).cpu().numpy(), parent.cpu().numpy()
    want = RKD.seed_sums(truth, parent, 1)
    assert want[1] > 1 << 30
    assert TK._seed_level_native(truth, parent, shift=1) == want
