"""fit_kernels_roofline: the least time of the traced steps' TF marches and
voxel-gradient marches (work/fit.py) over the card's time of the kernels
the program launched itself (not inside a PyTorch operator) inside the
harness's ``forward`` and ``backward`` ranges."""


def read(run):
    work = run.work.get("fit_kernels")
    dev = run.trace.device_s("forward", "backward", launcher="program")
    return 100.0 * work[2] / dev if work and dev > 0 else None
