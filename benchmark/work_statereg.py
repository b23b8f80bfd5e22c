"""Operations of the state-regression step, counted from its shapes (frozen
with the benchmark; the metrics cnn_roofline.statereg and mfu.statereg
read them).

Two operations a multiply-add of every convolution and matmul; the
elementwise work (BatchNorm, ReLU, pooling, the LSTM's gates) is not
counted.  The backward pass is twice the forward (the input's gradient
and the weights'), less the stem convolution's input gradient, which the
flow does not need.
"""
from __future__ import annotations

from benchmark.work import PEAK_F32_FLOPS  # noqa: F401  (the metrics' peak)

STEM = (64, 7, 2, 3)                       # channels, kernel, stride, padding
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))   # width, first stride
BLOCKS = 2


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet18_macs(h: int, w: int, in_ch: int, fdim: int) -> tuple:
    """(multiply-adds of one frame's forward pass, those of its stem
    convolution) for ResNet-18 on (h, w, in_ch) frames to ``fdim``
    features."""
    c, k, s, p = STEM
    h, w = _out(h, k, s, p), _out(w, k, s, p)
    stem = h * w * c * k * k * in_ch
    macs = stem
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)           # max pool
    n_in = c
    for width, stride in STAGES:
        for b in range(BLOCKS):
            st = stride if b == 0 else 1
            ho, wo = _out(h, 3, st, 1), _out(w, 3, st, 1)
            macs += ho * wo * width * 9 * n_in           # conv1
            macs += ho * wo * width * 9 * width          # conv2
            if st != 1 or n_in != width:
                macs += ho * wo * width * n_in           # 1x1 projection
            h, w, n_in = ho, wo, width
    return macs + n_in * fdim, stem


def cnn_flops(frames: int, h: int, w: int, in_ch: int, fdim: int) -> tuple:
    """(forward, backward) operations of the CNN over ``frames`` frames."""
    macs, stem = resnet18_macs(h, w, in_ch, fdim)
    return 2 * frames * macs, 2 * frames * (2 * macs - stem)


def temporal_flops(frames: int, fdim: int, v_hdim: int, mlp: list,
                   out_dim: int) -> tuple:
    """(forward, backward) operations of the bi-LSTM (``v_hdim`` // 2 a
    direction), the MLP and the head over ``frames`` frames."""
    hd = v_hdim // 2
    macs = 2 * frames * (fdim * 4 * hd + hd * 4 * hd)
    dims = [v_hdim, *mlp, out_dim]
    macs += frames * sum(a * c for a, c in zip(dims[:-1], dims[1:]))
    return 2 * macs, 4 * macs


def frames_flops(frames: int, work: dict) -> float:
    """All operations of training on ``frames`` frames at the run's
    shapes (``run.work``): the CNN's and the temporal net's forward and
    backward passes."""
    cf, cb = cnn_flops(frames, work["res"], work["res"], work["in_ch"],
                       work["cnn_fdim"])
    tf, tb = temporal_flops(frames, work["cnn_fdim"], work["v_hdim"],
                            work["mlp"], work["state_dim"])
    return cf + cb + tf + tb
