"""frames_per_s.orbit: every frame of the orbit that the window completed
over the whole window, to the drained card."""


def read(run):
    return run.window.frames / run.window.seconds
