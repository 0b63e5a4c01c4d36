"""frames_per_s.iso: every frame of the isovalue sweep that the window
completed over the whole window, to the drained card."""


def read(run):
    return run.window.frames / run.window.seconds
