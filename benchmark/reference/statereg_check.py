"""The state-regression cell's comparison.

The window's last training step is judged at the timed sizes, from the
program's weights, BatchNorm statistics and Adam state before it
(drivers/statereg.py keeps them).  The reference rebuilds the step's
batch from the seed, by the configuration's contract and nothing of the
program, and computes the step in float64 (plain/models/statereg_ref.py):

- ``batch_mismatch``: elements of the step's flow, targets and mask that
  differ from the rebuilt batch's (exact: the same draws and the same
  float32 rounding);
- ``feat_gap``, ``pred_gap``: the CNN's features (T, B, cnn_fdim) and the
  per-frame state predictions (T, B, D), relative RMS;
- ``loss_gap``: relative;
- ``grad_gap_cnn``, ``grad_gap_temporal``: the gradient's relative error
  in the worst parameter tensor of the CNN and of the temporal net
  (bi-LSTM, MLP, head), each group under a limit of its own: the CNN's
  BatchNorm backward rounds ~1000x coarser than the temporal net;
- ``change_gap_cnn``, ``change_gap_temporal``: Adam's change of the
  weights over the step, relative, in the worst tensor of each group;
- ``bn_stat_gap``: the step's change of the running statistics, the
  larger of the means' relative error and the variances'.

The relative error of x against the reference's y is ‖x - y‖ / ‖y‖.
With ``control`` the reference computed in float32 with TF32 on takes the
program's place (its own rebuilt batch: ``batch_mismatch`` 0).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from .plain.models import statereg_ref as R
from .plain.ops import math_utils as M

NQ = 59               # the synthetic humanoid's qpos width
FPS = 30.0
PAD = 30              # a chunk runs to fr_num + PAD frames at most
CHUNKS = 4            # a step's chunks where the configuration's batch_size is 1
HAND_COLS = ((32, 35), (42, 45))   # the noisy hand pose, zeroed


def synthetic_world(seed: int, n_takes: int, t_len: int, res: int) -> list:
    """Per take, (flow (T, res, res, 2) float32, qpos (T, NQ) float64) of
    ``--synthetic`` with the resolution set: standing sinusoidal motion
    from np.random.RandomState(seed), flow a linear map of the pose plus
    noise, both drawn from SFC64 seeded by the CRC-32 of the take's name
    (``synthetic_%02d``)."""
    rng = np.random.RandomState(seed)
    tt = np.arange(t_len) / FPS
    out = []
    for i in range(n_takes):
        qpos = np.zeros((t_len, NQ))
        qpos[:, 2] = 0.9
        qpos[:, 3] = 1.0
        freqs = rng.uniform(0.2, 0.8, NQ - 7)
        phases = rng.uniform(0, 2 * np.pi, NQ - 7)
        qpos[:, 7:] = 0.4 * np.sin(2 * np.pi * freqs * tt[:, None] + phases)
        fast = np.random.Generator(np.random.SFC64(
            zlib.crc32(f"synthetic_{i:02d}".encode())))
        w = fast.standard_normal((NQ, res * res * 2), dtype=np.float32) / NQ
        noise = 0.05 * fast.standard_normal((t_len, res, res, 2),
                                            dtype=np.float32)
        flow = (qpos @ w).reshape(t_len, res, res, 2).astype(np.float32)
        flow += noise
        out.append((flow, qpos))
    return out


def targets(qposes: list) -> list:
    """Per take, the normalised regression targets (T, 2 NQ - 3): the
    de-headed qpos[2:] and the heading-frame finite-difference velocity
    (the last frame's repeated), the hand columns zeroed first, each
    column standardised over every frame of every take."""
    trajs = []
    for q in qposes:
        q = q.copy()
        for a, b in HAND_COLS:
            q[:, a:b] = 0.0
        qt = torch.as_tensor(q, dtype=torch.float64)
        pos = qt[:, 2:].clone()
        pos[:, 1:5] = M.de_heading(pos[:, 1:5])
        vel = M.get_qvel_fd(qt[:-1], qt[1:], 1 / FPS, "heading")
        vel = torch.cat([vel, vel[-1:]])
        trajs.append(torch.cat([pos, vel], 1).numpy())
    every = np.vstack(trajs)
    mean, std = every.mean(axis=0), every.std(axis=0)
    return [(t - mean[None]) / (std[None] + 1e-8) for t in trajs]


def chunks(n_takes: int, t_len: int, fr_num: int, overlap: int) -> list:
    """(take, first frame, end) of each chunk, takes in order: fr_num
    frames from each start, the next start ``overlap`` frames before the
    end, a take's last chunk running to its end when fewer than PAD frames
    would be left over."""
    out = []
    for take in range(n_takes):
        start = 0
        while True:
            end = start + fr_num if start + fr_num + PAD < t_len else t_len
            out.append((take, start, end))
            if end == t_len:
                break
            start = end - overlap
    return out


def step_batch(cfg: dict, n_takes: int, t_len: int, res: int,
               step: int) -> dict:
    """The batch of training step ``step`` (counted over epochs from 0):
    batch_size chunks (CHUNKS where it is 1) side by side, each's flow
    padded to fr_num + PAD frames by repeating its last frame, its
    targets inside the margins and their mask; the epoch's last batch
    filled with zero-masked copies of its first chunk."""
    fr_num, margin = int(cfg["fr_num"]), int(cfg["fr_margin"])
    n_chunks = int(cfg["batch_size"]) if int(cfg["batch_size"]) > 1 \
        else CHUNKS
    world = synthetic_world(int(cfg["seed"]), n_takes, t_len, res)
    norm = targets([q for _, q in world])
    rows = [c for c in chunks(n_takes, t_len, fr_num, 2 * margin)
            if c[2] - c[1] > 2 * margin]
    groups = [rows[i:i + n_chunks] for i in range(0, len(rows), n_chunks)]
    group = groups[step % len(groups)]
    t_max = fr_num + PAD
    d = norm[0].shape[1]
    flow = np.zeros((t_max, n_chunks, res, res, 2), np.float32)
    gt = np.zeros((t_max - 2 * margin, n_chunks, d), np.float32)
    mask = np.zeros((t_max - 2 * margin, n_chunks), np.float32)
    for j in range(n_chunks):
        take, a, b = group[j] if j < len(group) else group[0]
        n = b - a
        flow[:n, j] = world[take][0][a:b]
        flow[n:, j] = world[take][0][b - 1]
        gt[:n - 2 * margin, j] = norm[take][a + margin:b - margin]
        if j < len(group):
            mask[:n - 2 * margin, j] = 1.0
    return dict(flow=torch.from_numpy(flow), gt=torch.from_numpy(gt),
                mask=torch.from_numpy(mask))


def rel(x, y) -> float:
    x, y = x.double().cpu(), y.double().cpu()
    if x.shape != y.shape or not bool(torch.isfinite(x).all()):
        return float("inf")
    return float((x - y).norm() / y.norm().clamp(min=1e-300))


def flat(d: dict, names) -> torch.Tensor:
    return torch.cat([d[k].double().cpu().reshape(-1) for k in names])


def check(cfg: dict, payload: dict, device, control: bool = False) -> dict:
    before, after = payload["before"], payload["after"]
    want = step_batch(cfg, payload["takes"], payload["frames"],
                      payload["res"], payload["step"])
    got = payload["batch"]
    mismatch = sum(int((got[k] != want[k]).sum()) if got[k].shape ==
                   want[k].shape else want[k].numel() for k in want)
    on = lambda d: {k: v.to(device) for k, v in d.items()}
    adam = None
    if before["adam"]["step"]:
        adam = dict(step=before["adam"]["step"],
                    exp_avg=on(before["adam"]["exp_avg"]),
                    exp_avg_sq=on(before["adam"]["exp_avg_sq"]))
    args = (on(before["params"]), on(before["buffers"]), adam,
            want["flow"].to(device), want["gt"].to(device),
            want["mask"].to(device), int(cfg["fr_margin"]), float(cfg["lr"]))
    ref = R.train_step(*args)
    if control:
        ctl = R.train_step(*args, dtype=torch.float32, allow_tf32=True)
        mismatch = 0
        prog = dict(feats=ctl["feats"], pred=ctl["pred"],
                    loss=float(ctl["loss"]), grads=ctl["grads"],
                    params=ctl["params"], buffers=ctl["buffers"])
    else:
        prog = dict(feats=payload["feats"], pred=payload["pred"],
                    loss=payload["loss"], grads=payload["grads"],
                    params=after["params"], buffers=after["buffers"])
    names = list(before["params"])
    cnn = [k for k in names if k.startswith("cnn.")]
    rest = [k for k in names if not k.startswith("cnn.")]
    delta = lambda d, old, ks: flat(d, ks) - flat(old, ks)
    worst = lambda x, y, ks: max(rel(x[k], y[k]) for k in ks)
    change = lambda d: {k: d["params"][k].double().cpu()
                        - before["params"][k].double() for k in names}
    prog_change, ref_change = change(prog), change(ref)
    stats = [[k for k in ref["buffers"] if k.endswith(f)]
             for f in ("running_mean", "running_var")]
    loss_ref = float(ref["loss"])
    return dict(
        batch_mismatch=mismatch,
        feat_gap=rel(prog["feats"], ref["feats"]),
        pred_gap=rel(prog["pred"], ref["pred"]),
        loss_gap=abs(prog["loss"] - loss_ref) / abs(loss_ref)
        if np.isfinite(prog["loss"]) else float("inf"),
        grad_gap_cnn=worst(prog["grads"], ref["grads"], cnn),
        grad_gap_temporal=worst(prog["grads"], ref["grads"], rest),
        change_gap_cnn=worst(prog_change, ref_change, cnn),
        change_gap_temporal=worst(prog_change, ref_change, rest),
        bn_stat_gap=max(rel(delta(prog["buffers"], before["buffers"], ks),
                            delta(ref["buffers"], before["buffers"], ks))
                        for ks in stats))
