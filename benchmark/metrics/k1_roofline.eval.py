"""K1's share of its roofline in the profiled eval steps (B = takes)."""
from benchmark.metrics._k1 import roofline


def read(run):
    return roofline(run, "step", run.work.get("takes", 0))
