"""kd_build_ms: the card's time of the kd-tree build (``build_device``: the
midrange pyramid, each level's Δ fit and encode, the prune, the chains), in
ms: the kernels, copies and fills launched inside the program's
``vr.kd.build`` span while the traced run's set-up ran under a profiler of
its own (``sessions/kd_pooled.py``).  Nothing where the program has no such
span."""


def read(run):
    s = run.work.get("setup", {}).get("vr.kd.build")
    return None if s is None else 1e3 * s
