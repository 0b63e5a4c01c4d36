"""frame_mfu.iso: the whole isosurface frame's share of the card's peak: the
least time of everything the traced frames had to do (work/iso.py: the
bind, the bound march, the shade) over the traced window's length."""


def read(run):
    work = run.work.get("frame")
    return 100.0 * work[2] / run.trace.window_s if work else None
