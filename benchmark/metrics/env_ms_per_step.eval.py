"""Host ms a control step of the env in the profiled eval steps: the self
time of the spans env.*: the observation and its filter, the step's
actions, its finish (guard, body quats, FK, reward, observation), the
re-anchor (_spans.py)."""
from benchmark.metrics._spans import read_layer


def read(run):
    return read_layer("env")
