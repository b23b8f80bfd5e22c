"""The rollout's host-clock sample time (SampleLog.sample_time, which ends
in a synchronisation) over the window's iterations, per control step
(all lanes together)."""


def read(run):
    if not run.iters:
        return None
    steps = sum(it["segment_steps"] for it in run.iters)
    return sum(it["sample_s"] for it in run.iters) / steps * 1e3
