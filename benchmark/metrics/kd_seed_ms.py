"""kd_seed_ms: the host's time of the kd-tree build's Δ seeding, in ms: the
sequential running mean of each level (``kdtree.seed_level``, the compiled
host helper), summed over the program's ``vr.kd.seed`` spans while the
traced run's set-up ran under a profiler of its own
(``sessions/kd_pooled.py``), the copies of each level to the host
included.  Nothing where the program has no such span."""


def read(run):
    s = run.work.get("setup", {}).get("vr.kd.seed.host")
    return None if s is None else 1e3 * s
