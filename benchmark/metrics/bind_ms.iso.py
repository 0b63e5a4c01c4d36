"""bind_ms.iso: the card's time of the iso bind (``IsosurfacePlan.bind``, the
block grid of the volume) per frame, from the kernels launched inside the
harness's ``bind`` range of the traced window."""


def read(run):
    t = run.trace
    return 1e3 * t.device_s("bind") / t.frames
