"""Host ms a control step of the physics in the profiled steps of the
rollout: the self time of the spans physics.*: the control step's host
preparation and launch; the kernel's device time is not in it
(_spans.py)."""
from benchmark.metrics._spans import read_layer


def read(run):
    return read_layer("physics")
