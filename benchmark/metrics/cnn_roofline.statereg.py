"""The CNN's share of its roofline in the profiled state-regression steps:
the least time of its forward and backward operations (benchmark/
work_statereg.py, over the padded frames the program counted in the
profiled steps, statereg.padded_frames) at 67 TFLOP/s float32, over the
device time of the kernels launched inside the spans
statereg.cnn_forward and statereg.cnn_backward (drivers/statereg.py).
The operations' time is the bound: the CNN is compute-bound (PERF.md
section 3)."""
from benchmark import work_statereg as W


def read(run):
    t = run.trace or {}
    frames = t.get("counts", {}).get("statereg.padded_frames")
    secs = sum(s for s, _ in t.get("sections", {}).values())
    if not frames or not secs:
        return None
    w = run.work
    fwd, bwd = W.cnn_flops(frames, w["res"], w["res"], w["in_ch"],
                           w["cnn_fdim"])
    return (fwd + bwd) / W.PEAK_F32_FLOPS / secs * 100
