"""Plain reference of one state-regression training step: EgoPose's
state-regression net (ICCV 2019, arXiv 1906.03173, Sec. 3.1; the
reference code base's ``models/video_reg_net.py`` with torchvision's
ResNet-18) trained with a masked mean squared error and Adam.

Written from that description in plain ``torch`` on whatever device and
dtype the inputs have (the benchmark runs it in float64); TF32 is off for
matmuls and cuDNN unless the caller asks for it (the control).  It
imports nothing of the program.  Parameters and buffers are one flat dict
keyed by the checkpoint's names (``cnn.conv1.weight``,
``cnn.layer2_0.down_bn.running_var``, ``v_net.rnn_b.hh.bias``,
``mlp.layers.1.weight``, ``linear.bias`` ...).

The net: each frame, (H, W, 2) optical flow given a zero third channel,
goes through ResNet-18 (a 7x7/2 stem of 64 channels, 3x3/2 max pool, two
basic blocks at each of 64, 128, 256, 512 channels, the first of each
stage after the stem striding 2 with a 1x1 projection, global average
pool) and a linear layer to ``cnn_fdim`` features; the (T, B) sequence of
features goes through a bidirectional LSTM (gates (i, f, g, o), input and
hidden biases both, half the width each way, the two directions
concatenated), an MLP with ReLU after each layer and a linear head to the
state.  BatchNorm in training mode normalises by the batch's mean and
biased variance (epsilon 1e-5) and moves the running statistics by
``running = 0.9 running + 0.1 batch``, with the biased variance (flax's
rule).  The loss is the squared error summed over the state's dimensions,
averaged over the frames that ``mask`` keeps in ``[fr_margin:-fr_margin]``
of each chunk.  Adam: beta 0.9 / 0.999, epsilon 1e-8 added outside the
square root, bias-corrected.

Departures from the reference code base, as the program makes them:
a step takes 4 chunks side by side on the batch axis (the code base steps
on one), and BatchNorm's statistics run over every frame of the step,
the padding that fills each chunk to ``fr_num`` + 30 frames included.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_KEEP = 0.9                 # running = BN_KEEP running + (1 - BN_KEEP) batch
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))   # width, first stride
BLOCKS = 2                    # basic blocks a stage


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for matmuls and cuDNN set to ``on`` for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def batch_norm(x, p, name, stats):
    """Training-mode BatchNorm over (N, C, H, W); the batch's mean and
    biased variance go into ``stats[name]``."""
    mean = x.mean((0, 2, 3))
    var = (x * x).mean((0, 2, 3)) - mean * mean
    stats[name] = (mean.detach(), var.detach())
    scale = p[name + ".weight"] * torch.rsqrt(var + BN_EPS)
    shift = p[name + ".bias"] - mean * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def basic_block(x, p, name, stride, stats):
    y = F.conv2d(x, p[name + ".conv1.weight"], stride=stride, padding=1)
    y = torch.relu(batch_norm(y, p, name + ".bn1", stats))
    y = F.conv2d(y, p[name + ".conv2.weight"], padding=1)
    y = batch_norm(y, p, name + ".bn2", stats)
    if name + ".down_conv.weight" in p:
        x = F.conv2d(x, p[name + ".down_conv.weight"], stride=stride)
        x = batch_norm(x, p, name + ".down_bn", stats)
    return torch.relu(y + x)


def resnet18(frames, p, stats):
    """(N, H, W, 3) frames -> (N, cnn_fdim) features."""
    x = frames.permute(0, 3, 1, 2)
    x = F.conv2d(x, p["cnn.conv1.weight"], stride=2, padding=3)
    x = torch.relu(batch_norm(x, p, "cnn.bn1", stats))
    x = F.max_pool2d(x, 3, 2, 1)
    for i, (_, stride) in enumerate(STAGES):
        for b in range(BLOCKS):
            x = basic_block(x, p, f"cnn.layer{i + 1}_{b}",
                            stride if b == 0 else 1, stats)
    return F.linear(x.mean((2, 3)), p["cnn.fc.weight"], p["cnn.fc.bias"])


def lstm(x, p, name, reverse):
    """One direction of the LSTM over (T, B, D)."""
    w_ih, b_ih = p[name + ".ih.weight"], p[name + ".ih.bias"]
    w_hh, b_hh = p[name + ".hh.weight"], p[name + ".hh.bias"]
    h = c = x.new_zeros(x.shape[1], w_hh.shape[1])
    out = [None] * x.shape[0]
    for t in (reversed(range(x.shape[0])) if reverse else range(x.shape[0])):
        i, f, g, o = (x[t] @ w_ih.T + b_ih + h @ w_hh.T + b_hh).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out)


def temporal(feats, p):
    """(T, B, cnn_fdim) features -> (T, B, state_dim) predictions."""
    h = torch.cat([lstm(feats, p, "v_net.rnn_f", False),
                   lstm(feats, p, "v_net.rnn_b", True)], -1)
    j = 0
    while f"mlp.layers.{j}.weight" in p:
        h = torch.relu(F.linear(h, p[f"mlp.layers.{j}.weight"],
                                p[f"mlp.layers.{j}.bias"]))
        j += 1
    return F.linear(h, p["linear.weight"], p["linear.bias"])


def adam(p, g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """Adam's t-th step (t from 1) on one tensor: (new p, new m, new v)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    step = lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
    return p - step, m, v


def train_step(params, buffers, adam_state, flow, gt, mask, fr_margin, lr,
               dtype=torch.float64, allow_tf32=False):
    """One training step from ``params`` / ``buffers`` (name -> tensor),
    ``adam_state`` (dict of ``step``, the steps taken, and ``exp_avg`` /
    ``exp_avg_sq``, name -> tensor, or None before the first step) on a
    batch (flow (T, B, H, W, 2), gt (T', B, D), mask (T', B)), computed in
    ``dtype``.  Returns a dict: ``feats`` (T, B, cnn_fdim), ``pred`` (T, B,
    D), ``loss``, ``grads``, ``params``, ``buffers`` and ``adam`` after
    the step."""
    cast = lambda x: x.detach().to(dtype)
    p = {k: cast(x).requires_grad_() for k, x in params.items()}
    flow, gt, mask = cast(flow), cast(gt), cast(mask)
    t_len, b = flow.shape[:2]
    stats = {}
    with tf32(allow_tf32):
        frames = torch.cat([flow, flow.new_zeros(flow.shape[:-1] + (1,))],
                           -1)
        feats = resnet18(frames.reshape((t_len * b,) + frames.shape[2:]), p,
                         stats).reshape(t_len, b, -1)
        pred = temporal(feats, p)
        err = ((gt - pred[fr_margin:-fr_margin]) ** 2).sum(-1) * mask
        loss = err.sum() / mask.sum().clamp(min=1.0)
        names = list(p)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [p[k] for k in names])))
    t = (adam_state["step"] if adam_state else 0) + 1
    new_p, new_m, new_v = {}, {}, {}
    for k in names:
        m = cast(adam_state["exp_avg"][k]) if adam_state \
            else torch.zeros_like(grads[k])
        v = cast(adam_state["exp_avg_sq"][k]) if adam_state \
            else torch.zeros_like(grads[k])
        new_p[k], new_m[k], new_v[k] = adam(p[k].detach(), grads[k], m, v,
                                            t, lr)
    new_bufs = {}
    for k, x in buffers.items():
        bn, field = k.rsplit(".", 1)
        if field == "running_mean":
            new_bufs[k] = BN_KEEP * cast(x) + (1 - BN_KEEP) * stats[bn][0]
        elif field == "running_var":
            new_bufs[k] = BN_KEEP * cast(x) + (1 - BN_KEEP) * stats[bn][1]
    return dict(feats=feats.detach(), pred=pred.detach(),
                loss=loss.detach(), grads=grads, params=new_p,
                buffers=new_bufs,
                adam=dict(step=t, exp_avg=new_m, exp_avg_sq=new_v))
