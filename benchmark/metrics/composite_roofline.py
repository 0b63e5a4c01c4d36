"""composite_roofline: the least time of the traced frames' compositing
marches (work/composite.py, from the reference's counts) over the card's
time of whatever ran inside the harness's ``render`` range."""


def read(run):
    work, dev = run.work.get("composite"), run.trace.device_s("render")
    return 100.0 * work[2] / dev if work and dev > 0 else None
