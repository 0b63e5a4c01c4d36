"""grid_ms.iso: the card's time per frame of the iso bind's block grid,
from the kernels launched inside the program's ``vr.grid`` spans (each a
build of the min/max 8^3 grid, ``ops/blockgrid.py``) in the traced window.
Nothing where the program has no ``vr.iso.bind`` span; 0 where it binds
without building a grid."""


def read(run):
    t = run.trace
    if not t.ranges.get("vr.iso.bind"):
        return None
    return 1e3 * t.device_s("vr.grid") / t.frames
