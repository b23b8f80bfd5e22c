"""The 95th percentile of every control step's latency in the window,
synchronisation to synchronisation (a real-time consumer's frame
budget is 33.3 ms at 30 Hz)."""
from benchmark.common import percentile


def read(run):
    if not run.step_s:
        return None
    return percentile(run.step_s, 95) * 1e3
