"""fit_steps_per_s: every fit step the window completed over the whole
window, to the drained card."""


def read(run):
    return run.window.frames / run.window.seconds
