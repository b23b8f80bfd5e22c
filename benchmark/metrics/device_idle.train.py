"""The device's idle share of the profiled slices of this cell."""
from benchmark.metrics._idle import idle


def read(run):
    return idle(run)
