"""In-the-wild ego-mimic evaluation (counterpart of
egopose_tpu/cli/ego_mimic_eval_wild.py): no ground-truth experts.

The policy rolls out (mean actions) against precomputed wild CNN features,
with the value fail-safe re-anchoring a take to the state-regression
prediction when the critic signals failure.  Every take is one lane of one
batch (features padded to the longest take by repeating its last frame),
so each control step is one launch of the CUDA control-step kernel over
all takes on the card.

    python -m egopose_tpu_torch.cli.ego_mimic_eval_wild --cfg subject_03 \\
        --iter 3000 --test-feat wild_01 [--device cuda|cpu] [--f64]

Reads datasets/features/cnn_feat_<test-feat>.p (a dict of take -> (T, F)
features, or (dict, mean)); writes
results/egomimic/<cfg>/results/iter_%04d_<test-feat>.p as (results, meta)
with results {traj_pred, vel_pred} keyed by take, the JAX package's layout.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch


def load_wild_features(cfg, test_feat):
    """The wild takes' CNN features: {take: (T, F)} from
    ``<data_dir>/features/cnn_feat_<test_feat>.p``, a bare dict or a
    (dict, mean) tuple."""
    feat_file = "%s/features/cnn_feat_%s.p" % (cfg.data_dir, test_feat)
    with open(feat_file, "rb") as f:
        cnn = pickle.load(f)
    return cnn[0] if isinstance(cnn, tuple) else cnn


def pad_takes(feats_list):
    """(B, T_max, F) float32: each take's features padded to the longest
    take by repeating its last frame (the bi-LSTM's backward direction runs
    over the padding, so the padding is part of the context)."""
    t_feat = max(f.shape[0] for f in feats_list)
    out = np.zeros((len(feats_list), t_feat, feats_list[0].shape[-1]),
                   np.float32)
    for i, f in enumerate(feats_list):
        out[i, :f.shape[0]] = f
        out[i, f.shape[0]:] = f[-1]
    return out


def main(argv=None, step_hook=None, phys_hook=None):
    """``step_hook(t)``, if given, is called after each step t of the
    rollout loop; ``phys_hook(t, state, action, new_state)`` after each
    step's physics, before the fail-safe."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--iter", type=int, default=0)
    parser.add_argument("--test-feat", default=None)
    parser.add_argument("--test-ind", type=int, default=-1)
    parser.add_argument("--show-noise", action="store_true", default=False)
    parser.add_argument("--render", action="store_true", default=False)
    parser.add_argument("--f64", action="store_true", default=False,
                        help="evaluate in float64 (parity runs); default f32")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without "
                             "CUDA), cpu runs the plain PyTorch path")
    args = parser.parse_args(argv)
    if args.render:
        raise NotImplementedError(
            "--render is not ported yet (ROADMAP §1 item 2)")

    from .. import envs, resolve_device
    from ..ops import running_norm
    from ..physics import substep
    from ..rl.agent_ego import AgentEgo
    from ..utils.config import EgoMimicConfig
    from ..utils.log import create_logger
    from .ego_mimic import build_world
    from .ego_mimic_eval import _select, reset_to_pred, state_net_pred

    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = EgoMimicConfig(args.cfg, create_dirs=False)
    logger = create_logger(os.path.join(cfg.log_dir, "log_eval_wild.txt"))

    cnn_feat_dict = load_wild_features(cfg, args.test_feat)
    takes = list(cnn_feat_dict.keys())
    if args.test_ind >= 0:
        takes = [takes[args.test_ind]]
    t0 = time.time()
    if device.type == "cuda":
        substep.build()               # nvcc at first use, outside the loop
    t_build = time.time() - t0

    spec, model, tables, p, expert, _ = build_world(cfg, dtype, device,
                                                    synthetic=True)
    fdim = np.asarray(cnn_feat_dict[takes[0]]).shape[-1]
    agent = AgentEgo(model, spec, p, tables, expert,
                     np.zeros((1, 8, fdim), np.float32), cfg, batch_lanes=1,
                     seed=cfg.seed, dtype=dtype, device=device)
    cp_path = "%s/iter_%04d.p" % (cfg.model_dir, args.iter)
    if os.path.exists(cp_path):
        agent.load(cp_path)
        logger.info("loaded policy from %s" % cp_path)

    m = cfg.fr_margin
    feats_list = [np.asarray(cnn_feat_dict[t], np.float32) for t in takes]
    test_lens = np.array([f.shape[0] - 2 * m for f in feats_list])
    if (test_lens <= 0).any():
        raise SystemExit("a wild take is shorter than 2*fr_margin frames")
    n_takes = len(takes)
    t_max = int(test_lens.max())
    feats_np = pad_takes(feats_list)
    t_feat = feats_np.shape[1]
    feats = torch.as_tensor(feats_np).to(device=device, dtype=dtype)
    with torch.no_grad():
        v_out_p = agent.policy_vs_net(feats)          # (B, T - 2m, v_hdim)
        v_out_v = agent.value_vs_net(feats)

    if getattr(cfg, "state_net_cfg", None) and \
            os.path.exists(getattr(cfg, "state_net_model", "")):
        # frame index t maps to take frame m + t
        state_preds = state_net_pred(cfg, feats_np, device, dtype)[:, m:]
        logger.info("loaded state net from %s" % cfg.state_net_model)
    else:            # the neutral standing prediction, rounded to float32
        row = torch.zeros(p.nq - 2 + p.nv, dtype=torch.float32)
        row[0], row[1] = 0.9, 1.0
        state_preds = row.to(device=device, dtype=dtype).expand(
            n_takes, t_feat - m, -1)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    st = envs.reset(model, p, tables, expert, gen, n_takes,
                    fix_expert_ind=0, fix_start_ind=p.fr_margin)
    st = reset_to_pred(p, tables, st, state_preds[:, 0])
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(cfg.seed)
    test_lens_t = torch.as_tensor(test_lens, device=device)
    vstat_n = torch.zeros(n_takes, dtype=dtype, device=device)
    vstat_mean = torch.zeros(n_takes, dtype=dtype, device=device)
    n_reset = torch.zeros(n_takes, dtype=torch.int64, device=device)
    rec_q, rec_v = [], []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    with torch.no_grad():
        for t in range(t_max):
            active = t < test_lens_t
            rec_q.append(st.qpos)
            rec_v.append(st.qvel)
            zobs = running_norm.apply(agent.zstat, envs.observe(p, st),
                                      clip=5.0)
            action, log_std = agent.policy_net(
                torch.cat([v_out_p[:, t], zobs], -1))
            if args.show_noise:
                action = action + torch.exp(log_std) * torch.randn(
                    action.shape, generator=noise_gen, device=device,
                    dtype=dtype)
            value = agent.value_net(torch.cat([v_out_v[:, t], zobs], -1))
            vstat_n = vstat_n + active
            vstat_mean = vstat_mean + torch.where(
                active, (value - vstat_mean) / torch.clamp(vstat_n, min=1),
                torch.zeros_like(value))
            # wild takes have no ground-truth head bound: never naive-fail
            new_st, _ = envs.step(model, p, tables, expert, st, action, 0.0,
                                  fix_head_lb=-10.0)
            if phys_hook is not None:
                phys_hook(t, st, action, new_st)
            trigger = (value < 0.6 * vstat_mean) & active \
                & (t + 1 < test_lens_t)
            resetted = reset_to_pred(p, tables, new_st, state_preds[:, t + 1])
            new_st = _select(trigger, resetted, new_st)
            st = _select(active, new_st, st)        # frozen once inactive
            n_reset = n_reset + trigger.to(torch.int64)
            if step_hook is not None:
                step_hook(t)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    n_frames = int(test_lens.sum())
    logger.info("wild eval rollout: %d frames over %d takes on %s -- kernel "
                "build %.2fs, execute %.2fs = %.0f frames/s"
                % (n_frames, n_takes, device, t_build, wall,
                   n_frames / max(wall, 1e-9)))

    qpos_traj = torch.stack(rec_q).cpu().numpy()          # (T, B, nq)
    qvel_traj = torch.stack(rec_v).cpu().numpy()
    n_reset = n_reset.cpu().numpy()
    traj_pred, vel_pred = {}, {}
    for i, take in enumerate(takes):
        tl = int(test_lens[i])
        traj_pred[take] = qpos_traj[:tl, i]
        vel_pred[take] = qvel_traj[:tl, i]
        logger.info("%s: %d frames, %d resets" % (take, tl, n_reset[i]))
    results = {"traj_pred": traj_pred, "vel_pred": vel_pred}
    meta = {"algo": "ego_mimic", "num_reset": int(n_reset.sum()),
            "num_reset_per_take": dict(zip(takes, n_reset.tolist())),
            "frames_per_sec": n_frames / max(wall, 1e-9), "wall_s": wall,
            "compile_s": t_build, "device": str(device), "steps": t_max}
    os.makedirs(cfg.result_dir, exist_ok=True)
    res_path = "%s/iter_%04d_%s.p" % (cfg.result_dir, args.iter,
                                      args.test_feat)
    with open(res_path, "wb") as f:
        pickle.dump((results, meta), f)
    logger.info("saved results to %s" % res_path)
    return results, meta


if __name__ == "__main__":
    main()
