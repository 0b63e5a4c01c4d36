"""grid_builds.iso: the block grids built per frame: the program's
``vr.grid`` spans that start inside the traced window over its frames.
Nothing where the program has no ``vr.iso.bind`` span; 0 where it binds
without building a grid."""


def read(run):
    t = run.trace
    if not t.ranges.get("vr.iso.bind"):
        return None
    return sum(t.t0 <= a <= t.t1 for a, _ in t.ranges.get("vr.grid", ())) / t.frames
