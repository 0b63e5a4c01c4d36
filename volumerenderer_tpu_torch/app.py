"""The end-to-end application: the reference ``main()``
(``main.cpp:84-422``), load bricks -> compress -> save -> decode a level cut
-> render frames, and its interactive camera-state machine (WASD and arrow
motion, mouse look, scroll zoom, isovalue steps: ``main.cpp:462-578``) as
pure functions over a ``CameraState``.

Counterpart of ``volumerenderer_tpu/app.py``: the state machine float for
float, and ``run`` with the same flow, timer labels and metric keys.  Two
differences, on purpose:

* ``RenderConfig.use_pallas_kernel`` is the kernel switch.  Set (the
  default), ``run`` plans once (``CompressedRenderer.make_plan(...,
  pooled=True)``: the decode, the slab pool and the empty-block bind) and
  renders each frame from the pool through the CUDA kernels (compositing:
  B7; isosurface: B8 and the pooled shade).  Unset, each frame is the
  plain render of the decoded cut (``CompressedRenderer.render``), which
  the JAX ``run`` always takes.  As there, compositing marches
  ``max_samples`` and the isosurface the default 300 samples.
* ``frame_ms`` is the mean over this call's frames.  The JAX ``run``
  brackets all its frames with one timer scope, so its ``frame_ms`` is the
  whole loop's time, averaged with the loops of earlier calls in the
  process.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .camera import Camera, generate_rays
from .codecs import kdtree as K
from .config import AppConfig
from .io.bricks import BrickGrid, file_brick_source, load_bricks
from .io.synthetic import sphere_volume, turbulence_volume
from .models.compressed import CompressedRenderer
from .utils.timer import DebugTimer, Metrics

__all__ = ["run", "CameraState", "move", "look", "zoom", "reset", "step_isovalue"]


# ---------------------------------------------------------------------------
# Camera-state machine (main.cpp:462-578)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CameraState:
    position: tuple = (0.0, 0.0, -0.75)      # main.cpp:33
    front: tuple = (0.0, 0.0, 1.0)
    up: tuple = (0.0, 1.0, 0.0)
    yaw: float = 0.0
    pitch: float = 0.0
    fov: float = 50.0
    iso_value: float = 40.0                  # main.cpp:52 (in 0..255)

    def camera(self, width: int, height: int) -> Camera:
        return Camera(position=self.position, front=self.front, up=self.up,
                      fov_y_degrees=self.fov, width=width, height=height)


def move(st: CameraState, key: str, dt: float) -> CameraState:
    """WASD/arrow motion (``do_movement``, main.cpp:462-478): speed 2.5*dt."""
    speed = 2.5 * dt
    pos = np.asarray(st.position, np.float64)
    front = np.asarray(st.front, np.float64)
    up = np.asarray(st.up, np.float64)
    if key == "up":
        pos = pos + speed * front
    elif key == "down":
        pos = pos - speed * front
    elif key == "left":
        right = np.cross(front, up)
        pos = pos - right / np.linalg.norm(right) * speed
    elif key == "right":
        right = np.cross(front, up)
        pos = pos + right / np.linalg.norm(right) * speed
    return dataclasses.replace(st, position=tuple(pos))


def look(st: CameraState, dx: float, dy: float) -> CameraState:
    """Mouse look (``mouse_callback``, main.cpp:525-566): yaw += dx,
    pitch += dy clamped to +-89; front from spherical angles."""
    yaw = st.yaw + dx
    pitch = min(89.0, max(-89.0, st.pitch + dy))
    front = (
        math.cos(math.radians(pitch)) * math.cos(math.radians(yaw)),
        math.sin(math.radians(pitch)),
        math.sin(math.radians(yaw)),
    )
    n = math.sqrt(sum(f * f for f in front))
    return dataclasses.replace(st, yaw=yaw, pitch=pitch,
                               front=tuple(f / n for f in front))


def zoom(st: CameraState, scroll: float) -> CameraState:
    """Scroll zoom (``scroll_callback``, main.cpp:509-518): fov in [1, 50]."""
    fov = st.fov
    if 1.0 <= fov <= 50.0:
        fov -= scroll
    return dataclasses.replace(st, fov=min(50.0, max(1.0, fov)))


def reset(st: CameraState) -> CameraState:
    """Enter key (``reset``, main.cpp:568-578)."""
    return CameraState(iso_value=st.iso_value)


def step_isovalue(st: CameraState, direction: int) -> CameraState:
    """Keys 0/1 step the isovalue by 5 within [0, 255] (main.cpp:489-498)."""
    v = st.iso_value + 5.0 * direction
    return dataclasses.replace(st, iso_value=min(255.0, max(0.0, v)))


# ---------------------------------------------------------------------------
# End-to-end pipeline
# ---------------------------------------------------------------------------

def load_volume(cfg: AppConfig) -> np.ndarray:
    """The dataset of ``cfg`` as a (Z, Y, X) uint8 volume (``main.cpp:242``):
    the Richtmyer-Meshkov bricks of one timestep, or a synthetic volume
    (the turbulence seeded by the timestep)."""
    ds = cfg.dataset
    if ds.source == "rm_bricks":
        grid = BrickGrid(ds.brick_dims, ds.volume_grid)
        I, J, Kb = ds.load_grid
        return load_bricks(file_brick_source(ds.top_dir, grid), grid, ds.num_bricks, I, J, Kb,
                           ds.timestep)
    if ds.synthetic_kind == "sphere":
        return sphere_volume(ds.synthetic_dims)
    return turbulence_volume(ds.synthetic_dims, seed=ds.timestep)


def frame_renderer(cfg: AppConfig, renderer: CompressedRenderer, rays):
    """A zero-argument callable giving one frame's (rgb, alpha or found):
    the pooled kernel plan, made here, with ``use_pallas_kernel``, the plain
    render of the decoded cut without it."""
    mode, r, cut = cfg.render.render_mode, cfg.render, cfg.codec.cut_depth
    if mode not in ("compositing", "isosurface"):
        raise ValueError(f"unknown render mode {mode!r}")
    if r.use_pallas_kernel:
        if mode == "isosurface":
            return renderer.make_plan(rays, cut, mode, iso_value=r.iso_value, pooled=True)
        return renderer.make_plan(rays, cut, mode, max_samples=r.max_samples, pooled=True)
    if mode == "isosurface":
        return lambda: renderer.render(rays, cut_depth=cut, mode=mode, iso_value=r.iso_value)
    return lambda: renderer.render(rays, cut_depth=cut, max_samples=r.max_samples)


def run(cfg: AppConfig = AppConfig(), num_frames: int = 1, save_tree: bool = False,
        device: torch.device | str = "cuda"):
    """The reference ``main()`` flow on ``device``.  Returns (frames, the
    (H, W, 3) rgb of each as a numpy array; metrics: ``volume_gb``,
    ``num_active_nodes``, ``compressed_bits_per_voxel``, ``frame_ms``)."""
    metrics = Metrics()

    # 1. load the dataset (main.cpp:242)
    DebugTimer.begin(1, "LOAD")
    volume = load_volume(cfg)
    DebugTimer.end("LOAD")
    metrics.record(volume_gb=volume.nbytes / 1e9)

    # 2. compress (main.cpp:251-259)
    DebugTimer.begin(1, "TOTAL_CONSTRUCTION")
    tree = K.build(volume, tolerance=cfg.codec.tolerance, max_epochs=cfg.codec.max_epochs)
    DebugTimer.end("TOTAL_CONSTRUCTION")
    metrics.record(num_active_nodes=tree.num_active_nodes,
                   compressed_bits_per_voxel=2 * tree.num_active_nodes / volume.size)

    # 3. save (main.cpp:267)
    if save_tree:
        K.save(tree, cfg.tree_path)

    # 4. upload, decode, plan, then the render loop (main.cpp:280-411)
    DebugTimer.begin(1, "PLAN")
    renderer = CompressedRenderer(tree, device=device)
    render = frame_renderer(cfg, renderer, generate_rays(cfg.render.camera, device=device))
    DebugTimer.end("PLAN", sync=renderer.dtree.packed_levels)
    frames, seconds = [], 0.0
    for _ in range(num_frames):
        DebugTimer.begin(num_frames, "LOOP")
        rgb, _ = render()
        frames.append(rgb.cpu().numpy())  # waits for the frame
        seconds += DebugTimer.end("LOOP")
    metrics.record(frame_ms=1e3 * seconds / max(num_frames, 1))
    return frames, metrics
