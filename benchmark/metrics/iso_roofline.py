"""iso_roofline: the least time of the traced frames' bound marches and
shades (work/iso.py, from the reference's counts) over the card's time of
whatever ran inside the harness's ``iso_render`` range."""


def read(run):
    work, dev = run.work.get("iso"), run.trace.device_s("iso_render")
    return 100.0 * work[2] / dev if work and dev > 0 else None
