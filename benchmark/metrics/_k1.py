"""K1's share of its roofline in a profiled slice: the least time of one
launch at the cell's batch and contact rows (benchmark/work.py) over the
profiler's mean device time of ``substep_kernel``."""
from benchmark import work

KERNEL = "substep_kernel"


def roofline(run, tag: str, bsz: int):
    t = (run.trace or {}).get("tags", {}).get(tag)
    if not t:
        return None
    names = [k for k in t["kernel_s"] if KERNEL in k and "dense" not in k]
    n = sum(t["kernel_n"][k] for k in names)
    if not n:
        return None
    mean_s = sum(t["kernel_s"][k] for k in names) / n
    floor, pair = work.active_rows(run.work["states"])
    return work.k1_bound_s(bsz, floor, pair) / mean_s * 100
