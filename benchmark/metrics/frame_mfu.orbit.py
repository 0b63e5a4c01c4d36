"""frame_mfu.orbit: the whole compositing frame's share of the card's peak:
the least time of the traced frames' marches (work/composite.py) over the
traced window's length."""


def read(run):
    work = run.work.get("frame")
    return 100.0 * work[2] / run.trace.window_s if work else None
