"""kd_decode_ms: the card's time of the level cut's decode (one in set-up,
whose cut gives the block maxima and the slab pool), in ms: the kernels,
copies and fills launched inside the program's ``vr.kd.decode`` spans while
the traced run's set-up ran under a profiler of its own
(``sessions/kd_pooled.py``).  Nothing where the program has no such span."""


def read(run):
    s = run.work.get("setup", {}).get("vr.kd.decode")
    return None if s is None else 1e3 * s
