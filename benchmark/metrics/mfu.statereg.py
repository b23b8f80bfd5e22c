"""The state-regression step's share of the H100's float32 peak: the
operations of the window's real frames (benchmark/work_statereg.py: the
CNN's, the bi-LSTM's, the MLP's and the head's forward and backward
passes; each chunk's frames with its margins, not the copies of its last
frame that pad it) over the window's wall time x 67 TFLOP/s."""
from benchmark import work_statereg as W


def read(run):
    if not run.step_s:
        return None
    ops = W.frames_flops(run.work["real_frames"], run.work)
    return ops / run.window_s / W.PEAK_F32_FLOPS * 100
