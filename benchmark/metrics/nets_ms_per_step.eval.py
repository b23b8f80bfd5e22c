"""Host ms a control step of the nets in the profiled eval steps: the self
time of the spans nets.*: the policy's and the value's forwards with
their inputs, the action's sampling, the value statistics, the state
LSTM's step (_spans.py)."""
from benchmark.metrics._spans import read_layer


def read(run):
    return read_layer("nets")
