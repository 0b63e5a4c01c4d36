"""pooled_roofline: the least time of the traced frames' pooled compositing
marches (B7; work/pooled.py, the pool words the taps read, from the
reference's march) over the card's time of whatever ran inside the
program's ``vr.composite.render_pooled`` spans.  Nothing where the program
has no such span."""


def read(run):
    work, dev = run.work.get("pooled"), run.trace.device_s("vr.composite.render_pooled")
    return 100.0 * work[2] / dev if work and dev > 0 else None
