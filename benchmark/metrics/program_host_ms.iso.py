"""program_host_ms.iso: the host's time per frame inside the program's
``vr.iso.bind`` and ``vr.iso.render`` spans in the traced window: checks,
allocations and launches of the bind and of the bound march and shade.
Nothing where the program has no such span."""


def read(run):
    t = run.trace
    if not t.ranges.get("vr.iso.bind"):
        return None
    return 1e3 * (t.host_s("vr.iso.bind") + t.host_s("vr.iso.render")) / t.frames
