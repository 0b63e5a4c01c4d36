"""setup_s: seconds from the process's start to the window's opening: the
kernels' build (in a fresh checkout), the inputs made on the card, the
plans, the first steps of a fit and the warm-up to a steady allocator."""


def read(run):
    return run.setup_s
