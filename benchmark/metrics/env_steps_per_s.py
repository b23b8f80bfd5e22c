"""Env steps (lanes x control steps) of the window's whole iterations,
sample and update together, over the window's wall time."""


def read(run):
    if not run.iters:
        return None
    return sum(it["steps"] for it in run.iters) / run.window_s
