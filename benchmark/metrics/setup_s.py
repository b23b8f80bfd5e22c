"""Set-up time: process start to the first timed step (imports, the
kernels' load, the world, the checkpoint or the nets, the warm-up)."""


def read(run):
    return run.setup_s
