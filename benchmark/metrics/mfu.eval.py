"""The eval step's share of the H100's float32 peak: the operations the
window's steps need (benchmark/work.py: policy and value MLPs, K1) over
the window's wall time x 67 TFLOP/s."""
from benchmark import work


def read(run):
    if not run.step_s:
        return None
    floor, pair = work.active_rows(run.work["states"])
    ops = run.work["steps"] * work.eval_step_flops(
        run.config, run.work["takes"], floor, pair)
    return ops / run.window_s / work.PEAK_F32_FLOPS * 100
