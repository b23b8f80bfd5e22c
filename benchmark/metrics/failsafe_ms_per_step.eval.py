"""Host ms a control step of the eval's value fail-safe in the profiled
eval steps (span eval.failsafe: the trigger, the re-anchor to the state
prediction, the per-take selects), self time from the program's spans
(_spans.py)."""
from benchmark.metrics._spans import read_layer


def read(run):
    return read_layer("failsafe")
