"""The training iteration's share of the H100's float32 peak: the
operations the window's iterations need (benchmark/work.py: the
rollout's nets and K1, the update's forward and backward passes over
every epoch) over the window's wall time x 67 TFLOP/s."""
from benchmark import work


def read(run):
    if not run.iters:
        return None
    floor, pair = work.active_rows(run.work["states"])
    ops = sum(work.train_iter_flops(run.config, run.work["lanes"],
                                    it["segment_steps"], run.work["epochs"],
                                    floor, pair) for it in run.iters)
    return ops / run.window_s / work.PEAK_F32_FLOPS * 100
