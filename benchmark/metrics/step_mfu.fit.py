"""step_mfu.fit: the whole fit step's share of the card's peak: the least
time of the traced steps' work (work/fit.py: the volume read and written,
the rays and targets read, the marches' operations) over the traced
window's length."""


def read(run):
    work = run.work.get("step")
    return 100.0 * work[2] / run.trace.window_s if work else None
