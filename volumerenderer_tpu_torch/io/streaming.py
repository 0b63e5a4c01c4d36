"""Progressive multi-timestep streaming (BASELINE config 5).

Counterpart of ``volumerenderer_tpu/io/streaming.py``.  The reference loads
one timestep, compresses it and renders it interactively
(``main.cpp:242-290``).  For time-varying data the stages overlap across
timesteps:

  host I/O (brick files -> dense array) -> host compression (the kd-tree
  build, its Δ seeding native) -> upload, device decode and render

A worker thread loads and compresses timestep t+1 (host work only) while
the consumer renders timestep t; a bounded queue keeps at most ``prefetch``
timesteps in flight, and the consumer uploads each tree to ``device`` as it
takes it.  With ``cache_dir`` every tree is saved as ``tree_{t:04d}.bin``
(``codecs.kdtree.save``) and a later stream resumes from those files without
reading a brick: ``open_tree_full`` rebuilds the level layout, so a resumed
timestep keeps the compressed renderer.

Only the checkpoint's own ``ValueError`` of ``open_tree_full`` (its
preorder stream does not round-trip) takes the decode-only ``"raw"`` path,
a sequential decode rendered dense.  Any other failure of the worker (a
brick that will not load, a native library that will not build, an I/O
error) is raised in the consumer.  The worker's first build may compile the
native Δ seeding while the consumer compiles another library:
``ops/cuda/_build.load`` holds one lock per library, so two threads never
build or load one library at once.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, Sequence

import torch

from ..codecs import kdtree as K
from ..codecs.reference_impl import decode_preorder
from ..models.compressed import CompressedRenderer, DenseRenderer
from .bricks import BrickGrid, load_bricks

__all__ = ["TimestepStreamer"]


class TimestepStreamer:
    """Iterate (timestep, renderer) pairs, prefetching in a worker thread:
    a ``CompressedRenderer`` on ``device``, or for a checkpoint that does not
    round-trip a ``DenseRenderer`` of its sequential decode."""

    def __init__(self, source: Callable, grid: BrickGrid, timesteps: Sequence[int],
                 num_bricks: int, I: int, J: int, K_bricks: int,
                 tolerance: int = 6, max_epochs: int = 2, prefetch: int = 1,
                 cache_dir: str | None = None, device: torch.device | str = "cuda"):
        self.source = source
        self.grid = grid
        self.timesteps = list(timesteps)
        self.shape_args = (num_bricks, I, J, K_bricks)
        self.tolerance = tolerance
        self.max_epochs = max_epochs
        self.cache_dir = cache_dir
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._worker = threading.Thread(target=self._produce, daemon=True)
        self._started = False

    # -- producer (worker thread): I/O and compression, on the host --------- #

    def _path(self, t: int) -> str:
        return os.path.join(self.cache_dir, f"tree_{t:04d}.bin")

    def _build_one(self, t: int):
        if self.cache_dir and os.path.exists(self._path(t)):
            try:
                return ("tree", t, K.open_tree_full(self._path(t)))
            except ValueError:
                return ("raw", t, K.open_tree(self._path(t)))
        num_bricks, I, J, Kb = self.shape_args
        vol = load_bricks(self.source, self.grid, num_bricks, I, J, Kb, t)
        tree = K.build(vol, tolerance=self.tolerance, max_epochs=self.max_epochs)
        if self.cache_dir:
            K.save(tree, self._path(t))
        return ("tree", t, tree)

    def _produce(self):
        try:
            for t in self.timesteps:
                self._q.put(self._build_one(t))
        except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
            self._q.put(("error", -1, e))
        self._q.put(("done", -1, None))

    # -- consumer: upload, decode and render --------------------------------- #

    def __iter__(self) -> Iterator:
        if not self._started:
            self._worker.start()
            self._started = True
        while True:
            kind, t, payload = self._q.get()
            if kind == "done":
                return
            if kind == "error":
                raise payload
            if kind == "raw":
                vol = decode_preorder(payload["preorder"], payload["distance_map"],
                                      *payload["dims"], payload["orig_depth"],
                                      payload["max_depth"], payload["max_depth"])
                yield t, DenseRenderer(vol, device=self.device)
            else:
                yield t, CompressedRenderer(payload, device=self.device)
