"""Take-frames evaluated in the window (steps x takes) over its wall
time."""


def read(run):
    if not run.step_s:
        return None
    return run.frames / run.window_s
