"""Camera paths of the traffic mixes: a fixed camera and the bench's orbit.
Each gives the reference's ``Camera`` for frame ``t``; the session hands
the same numbers to the program."""
from __future__ import annotations

import random

from .reference import Camera, orbit_camera


def start_camera(cfg: dict) -> Camera:
    w, h = cfg["image"]
    return Camera(position=tuple(cfg["camera"]["position"]), front=tuple(cfg["camera"]["front"]),
                  up=tuple(cfg["camera"]["up"]), fov_y_degrees=float(cfg["camera"]["fov_y"]),
                  width=w, height=h)


class Path:
    """``path(t)`` -> Camera for frame ``t`` (t >= 0), from a start drawn
    from the seed; ``cycle`` is the number of cameras before the path
    repeats."""

    def __init__(self, cfg: dict, spec: dict, seed: int):
        kind = spec["path"]
        w, h = cfg["image"]
        fov = float(cfg["camera"]["fov_y"])
        if kind == "fixed":
            self.cameras = [start_camera(cfg)]
        elif kind == "orbit":
            every = int(spec.get("take_every", 1))
            self.cameras = [orbit_camera(float(spec["step_deg"]) * i, w, h, fov)
                            for i in range(0, int(spec["count"]), every)]
        else:
            raise ValueError(f"unknown camera path {kind!r}")
        self.offset = random.Random(int(seed) ^ 0x5EED).randrange(len(self.cameras))

    @property
    def cycle(self) -> int:
        return len(self.cameras)

    def index(self, t: int) -> int:
        """The camera index of frame ``t`` on a cyclic path."""
        return (t + self.offset) % len(self.cameras)

    def __call__(self, t: int) -> Camera:
        return self.cameras[self.index(t)]
