"""K1's share of its roofline in the profiled rollout steps (B = lanes)."""
from benchmark.metrics._k1 import roofline


def read(run):
    return roofline(run, "sample", run.work.get("lanes", 0))
