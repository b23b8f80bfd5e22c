"""Host ms a training step of the state-regression net's temporal half in
the profiled steps: the self time of the spans statereg.temporal_forward
(the eager bi-LSTM, the MLP, the head and the masked loss) and
statereg.temporal_backward (their autograd pass), each a mean over its
calls (_spans.py)."""
from benchmark.metrics._spans import mean_self_ms, program_spans

NAMES = ("statereg.temporal_forward", "statereg.temporal_backward")


def read(run):
    spans = program_spans()
    means = mean_self_ms(spans) if spans else {}
    if not all(n in means for n in NAMES):
        return None
    return sum(means[n] for n in NAMES)
