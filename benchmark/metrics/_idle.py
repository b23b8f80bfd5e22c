"""The device's idle share of the profiled slices: one less the union of
its kernel and copy intervals over the slices' wall time."""


def idle(run):
    t = run.trace
    if not t or not t["window_s"]:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100
