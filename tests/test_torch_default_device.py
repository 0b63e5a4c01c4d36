"""The port's entry points run on the card unless the caller asks for the CPU.

Each entry point is called without a device.  With a CUDA device the result
lies on it; without one (CPU-only torch) the call raises torch's own "no
CUDA" error or, for a mesh, says that a CPU mesh must be asked for: nothing
falls back to the CPU.  Whether there is a card is decided inside the test.
"""
import inspect

import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import (Camera, TFParams, as_normalized_volume, generate_rays,
                                      interop)
from volumerenderer_tpu_torch import app as TA
from volumerenderer_tpu_torch import config as TCFG
from volumerenderer_tpu_torch import entry as TE
from volumerenderer_tpu_torch import native
from volumerenderer_tpu_torch.codecs import reference_impl as RI
from volumerenderer_tpu_torch.io.bricks import BrickGrid, synthetic_brick_source
from volumerenderer_tpu_torch.io.streaming import TimestepStreamer
from volumerenderer_tpu_torch.utils.timer import DebugTimer
from volumerenderer_tpu_torch.camera import RayBundle
from volumerenderer_tpu_torch.codecs import device as CD
from volumerenderer_tpu_torch.codecs import kdtree as KT
from volumerenderer_tpu_torch.codecs import midrange as MR
from volumerenderer_tpu_torch.codecs.diff import DiffDecoder
from volumerenderer_tpu_torch.models import CompressedRenderer, DenseRenderer
from volumerenderer_tpu_torch.parallel import (bricks, context, make_brick_mesh, make_mesh,
                                               make_z_mesh, sharding)


def _tree_volume():
    v = np.zeros((8, 8, 8), np.uint8)
    v[2:6, 2:6, 2:6] = 200
    return v


def _tree():
    return KT.build(_tree_volume(), tolerance=2, max_epochs=1)


def _fields():
    return {k: np.asarray(v.numpy()) for k, v in TFParams.reference(device="cpu")._asdict().items()}


ENTRY_POINTS = {
    "generate_rays": (generate_rays, lambda: generate_rays(Camera(width=8, height=4))),
    "to_device": (CD.to_device, lambda: CD.to_device(_tree())),
    "CompressedRenderer": (CompressedRenderer.__init__, lambda: CompressedRenderer(_tree())),
    "DenseRenderer": (DenseRenderer.__init__,
                      lambda: DenseRenderer(torch.zeros((4, 4, 4), dtype=torch.uint8))),
    "TFParams.reference": (TFParams.reference, lambda: TFParams.reference()),
    "volume_from_numpy": (interop.volume_from_numpy,
                          lambda: interop.volume_from_numpy(np.zeros((4, 4, 4), np.uint8))),
    "rays_from_numpy": (interop.rays_from_numpy, lambda: interop.rays_from_numpy(
        np.zeros((2, 2, 3)), np.ones((2, 2, 3)), np.ones((2, 2), bool))),
    "tf_params_from_numpy": (interop.tf_params_from_numpy,
                             lambda: interop.tf_params_from_numpy(**_fields())),
    "DiffDecoder": (DiffDecoder.__init__, lambda: DiffDecoder(_tree()).dm0),
    "to_device_pair": (MR.to_device_pair, lambda: MR.to_device_pair(
        MR.build(_tree_volume(), tolerance=2, max_epochs=1))),
    "TimestepStreamer": (TimestepStreamer.__init__, lambda: next(iter(_streamer()))[1]),
    "entry": (TE.entry, lambda: TE.entry()[1]),
}


def _streamer():
    grid = BrickGrid(brick_dims=(4, 4, 4), grid=(2, 2, 2))
    return TimestepStreamer(synthetic_brick_source(grid), grid, [270, 271], num_bricks=8, I=2,
                            J=2, K_bricks=2, tolerance=2, max_epochs=1)


def _app_config():
    return TCFG.AppConfig(
        render=TCFG.RenderConfig(camera=Camera(width=8, height=4), max_samples=16),
        codec=TCFG.CodecConfig(tolerance=2, max_epochs=1),
        dataset=TCFG.DatasetConfig(synthetic_dims=(8, 8, 8)))

MESHES = {"make_mesh": lambda: make_mesh(2), "make_z_mesh": lambda: make_z_mesh(2),
          "make_brick_mesh": lambda: make_brick_mesh((2, 1, 1)),
          "default_devices": lambda: sharding.default_devices(2)}


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, CompressedRenderer):
        return list(out.dtree.packed_levels)
    if isinstance(out, DenseRenderer):
        return [out.volume_at()]
    if isinstance(out, tuple):
        return [t for o in out for t in _tensors(o)]
    if hasattr(out, "_asdict"):
        return [t for o in out._asdict().values() for t in _tensors(o)]
    if hasattr(out, "packed_levels"):
        return list(out.packed_levels)
    if isinstance(out, RayBundle):
        return [out.entry_uv, out.direction, out.hit]
    return []


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(AssertionError, match="CUDA"):
            call()
        return
    tensors = _tensors(call())
    assert tensors and all(t.device.type == "cuda" for t in tensors)


def test_numpy_volume_defaults_to_the_card():
    """``as_normalized_volume`` places a numpy volume on the card and leaves
    a tensor on its own device."""
    cpu = torch.zeros((4, 4, 4), dtype=torch.uint8)
    assert as_normalized_volume(cpu).device == cpu.device
    if not torch.cuda.is_available():
        with pytest.raises(AssertionError, match="CUDA"):
            as_normalized_volume(np.zeros((4, 4, 4), np.uint8))
        return
    assert as_normalized_volume(np.zeros((4, 4, 4), np.uint8)).device.type == "cuda"


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_defaults_to_the_cards(name):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MESHES[name]()
        return
    mesh = MESHES[name]()
    devices = mesh if isinstance(mesh, list) else list(mesh.devices.flat)
    assert all(d.type == "cuda" for d in devices)


def test_cpu_meshes_are_asked_for():
    cpu = [torch.device("cpu")] * 4
    assert make_mesh(devices=cpu, dp=2).shape == {"dp": 2, "rays": 2}
    assert context.make_z_mesh(devices=cpu).shape == {"z": 4}
    assert bricks.make_brick_mesh((2, 2, 1), devices=cpu).shape == {"bz": 2, "by": 2, "bx": 1}


def test_app_run_defaults_to_the_card(monkeypatch):
    """``app.run`` uploads its tree to the card: its frames come back as
    numpy arrays, so the renderer it makes is watched."""
    assert inspect.signature(TA.run).parameters["device"].default == "cuda"
    devices = []
    made = TA.CompressedRenderer

    def watched(tree, device):
        devices.append(torch.device(device))
        return made(tree, device)

    monkeypatch.setattr(TA, "CompressedRenderer", watched)
    if not torch.cuda.is_available():
        with pytest.raises(AssertionError, match="CUDA"):
            TA.run(_app_config())
        return
    frames, _ = TA.run(_app_config())
    assert devices == [torch.device("cuda")] and frames[0].shape == (4, 8, 3)


@pytest.mark.parametrize("call", ["build_arbitrary", "preorder_to_levels"])
def test_native_helper_by_default_where_there_is_a_card(call, monkeypatch):
    """``use_native=None`` takes the native pass on a machine with a CUDA
    device and the Python walk elsewhere (no build is tried here)."""
    used = []
    for name in ("build_full", "preorder_to_levels"):
        real = getattr(native.kdtree_native, name)
        monkeypatch.setattr(native.kdtree_native, name,
                            staticmethod(lambda *a, _r=real, _n=name, **k: used.append(_n)
                                         or _r(*a, **k)))
    vol = _tree_volume()
    if call == "build_arbitrary":
        tree = RI.build_arbitrary(vol, tolerance=2, max_epochs=1)
        want = RI.build_arbitrary(vol, tolerance=2, max_epochs=1, use_native=False)
        np.testing.assert_array_equal(tree.preorder, want.preorder)
    else:
        t = _tree()
        levels, _ = KT.preorder_to_levels(KT.to_preorder(t), t.orig_depth, t.max_depth)
        for a, b in zip(levels, t.level_codes):
            np.testing.assert_array_equal(a, b)
    want_calls = {"build_arbitrary": ["build_full"], "preorder_to_levels": ["preorder_to_levels"]}
    assert used == (want_calls[call] if torch.cuda.is_available() else [])


def test_timer_end_waits_for_the_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    DebugTimer.begin(1, "card")
    if not torch.cuda.is_available():
        with pytest.raises(AssertionError, match="CUDA"):
            DebugTimer.end("card", sync=torch.ones(2, device="cuda"))
        return
    x = torch.ones(2, device="cuda")
    DebugTimer.end("card", sync={"rgb": x, "host": torch.ones(2)})
    assert synced == [x.device]
