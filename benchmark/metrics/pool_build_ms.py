"""pool_build_ms: the card's time of the pair16 slab pool's build (the
packing, the slabs' dedup, the copy into the pool), in ms: the kernels,
copies and fills launched inside the program's ``vr.pool.build`` span
while the traced run's set-up ran under a profiler of its own
(``sessions/kd_pooled.py``).  Nothing where the program has no such span."""


def read(run):
    s = run.work.get("setup", {}).get("vr.pool.build")
    return None if s is None else 1e3 * s
