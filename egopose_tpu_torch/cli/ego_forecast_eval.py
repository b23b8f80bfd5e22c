"""Ego-forecast evaluation: closed-loop forecasting over sliding windows
(counterpart of egopose_tpu/cli/ego_forecast_eval.py, ``--mode save``).

Windows start every fr_margin frames across each take; each rolls the
forecast policy (mean actions) for env_episode_len steps from a state
taken from the ego-mimic estimation results (or the ground truth with
``--gt-init``), conditioned only on the fr_margin past video frames.  Every
window of every take is one lane of a single batch, so each control step is
one launch of the CUDA control-step kernel over all windows on the card.

    python -m egopose_tpu_torch.cli.ego_forecast_eval --cfg subject_03_syn \\
        --synthetic --iter N [--gt-init] [--device cuda|cpu] [--f64]

Writes results/egoforecast/<cfg>/results/iter_%04d_<data>[_gt].p as
(results, meta) with results {traj_pred, traj_orig} keyed by take, each
(n_windows, fr_margin + env_episode_len, nq): the JAX package's layout.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np


def window_lanes(lens, m, test_len, expert_ind=-1, start_ind=None):
    """(take, start frame) of every window: starts m, 2m, ... while the
    window's test_len steps stay inside the take; ``expert_ind`` >= 0 keeps
    one take's windows, ``start_ind`` the windows that start there."""
    lane_take, lane_start = [], []
    for i, n in enumerate(lens):
        for start in range(m, int(n) - test_len + 1, m):
            lane_take.append(i)
            lane_start.append(start)
    lane_take = np.array(lane_take, np.int64)
    lane_start = np.array(lane_start, np.int64)
    keep = np.ones(len(lane_take), bool)
    if expert_ind >= 0:
        keep &= lane_take == expert_ind
    if start_ind is not None:
        keep &= lane_start == start_ind
    return lane_take[keep], lane_start[keep]


def em_init_rows(em_res, em_offset, takes, expert_qpos, lane_take,
                 lane_start, m, test_len, nq, nv):
    """Each window's initial (qpos, qvel) and its m past qpos rows from
    the estimation results (the paper's protocol): slice the estimated
    trajectory around the window, re-anchor its heading and xy to the
    expert at start - m (sync_traj) where the slice is whole, start from
    the estimate at the window start, and replay the estimate's past
    frames (the expert's where the estimate does not reach back)."""
    from ..utils.tools import sync_traj
    n = len(lane_take)
    init_qpos = np.zeros((n, nq), np.float64)
    init_qvel = np.zeros((n, nv), np.float64)
    margin_rows = np.zeros((n, m, nq), np.float64)
    for li in range(n):
        i, s = int(lane_take[li]), int(lane_start[li])
        take = takes[i] if i < len(takes) else f"take_{i}"
        lo = max(0, s - m - em_offset)
        hi = s + test_len - em_offset
        sp = np.asarray(em_res["traj_pred"][take][lo:hi])
        vp = np.asarray(em_res["vel_pred"][take][lo:hi])
        miss = m + test_len - sp.shape[0]
        if s - m - em_offset >= 0:
            sp, vp = sync_traj(sp, vp, expert_qpos[i, s - m])
        init_qpos[li], init_qvel[li] = sp[m - miss], vp[m - miss]
        for t in range(m):
            margin_rows[li, t] = expert_qpos[i, s - m + t] if t < miss \
                else sp[t - miss]
    return init_qpos, init_qvel, margin_rows


def main(argv=None, step_hook=None):
    """``step_hook(t, state, action, new_state)``, if given, is called
    after each control step t with the windows' EnvState before and after
    it and the action taken."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--iter", type=int, default=0)
    parser.add_argument("--data", default="test")
    parser.add_argument("--mode", default="save")
    parser.add_argument("--gt-init", action="store_true", default=False)
    parser.add_argument("--em-iter", "--egomimic-iter", type=int,
                        dest="em_iter", default=None,
                        help="ego-mimic eval results iteration to initialize "
                             "windows from (default: cfg.ego_mimic_iter)")
    parser.add_argument("--synthetic", action="store_true", default=False)
    parser.add_argument("--f64", action="store_true", default=False,
                        help="evaluate in float64 (parity runs); default f32")
    parser.add_argument("--expert-ind", type=int, default=-1,
                        help="restrict to one take's windows (default all)")
    parser.add_argument("--start-ind", type=int, default=None,
                        help="restrict to the windows starting at this frame")
    parser.add_argument("--show-noise", action="store_true", default=False,
                        help="sampled instead of mean actions")
    parser.add_argument("--render", action="store_true", default=False)
    parser.add_argument("--verbose", action="store_true", default=False,
                        help="one log line per failed window")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without "
                             "CUDA), cpu runs the plain PyTorch path")
    args = parser.parse_args(argv)
    if args.mode == "vis" or args.render:
        raise NotImplementedError(
            "--mode vis / --render are not ported yet (ROADMAP §1 item 2)")
    if args.mode != "save":
        raise SystemExit("unknown --mode %s (save|vis)" % args.mode)

    import torch
    from .. import envs, resolve_device
    from ..ops import running_norm
    from ..physics import substep
    from ..rl.agent_forecast import AgentForecast, gather_past_windows
    from ..utils.config import EgoForecastConfig, EgoMimicConfig
    from ..utils.log import create_logger
    from .ego_mimic import build_world

    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = EgoForecastConfig(args.cfg, create_dirs=False)
    logger = create_logger(os.path.join(cfg.log_dir, "log_eval.txt"))
    np.random.seed(cfg.seed)
    if device.type == "cuda":
        substep.build()               # nvcc at first use, outside the loop

    spec, model, tables, p, expert, cnn_feat = build_world(
        cfg, dtype, device, synthetic=args.synthetic, data=args.data)
    agent = AgentForecast(model, spec, p, tables, expert, cnn_feat, cfg,
                          batch_lanes=1, seed=cfg.seed, dtype=dtype,
                          device=device)
    cp_path = "%s/iter_%04d.p" % (cfg.model_dir, args.iter)
    if os.path.exists(cp_path):
        logger.info("loading policy from checkpoint: %s" % cp_path)
        agent.load(cp_path)
    else:
        logger.info("no checkpoint at %s -- evaluating untrained policy"
                    % cp_path)

    n_takes = expert.qpos.shape[0]
    takes = cfg.takes[args.data] if cfg.takes[args.data] else \
        [f"take_{i}" for i in range(n_takes)]
    m, test_len = cfg.fr_margin, cfg.env_episode_len
    lane_take, lane_start = window_lanes(
        expert.lens.cpu().numpy(), m, test_len, args.expert_ind,
        args.start_ind)
    n_lanes = len(lane_take)
    if n_lanes == 0:
        raise SystemExit("no forecast windows match --expert-ind/--start-ind")
    logger.info("%d forecast windows across %d takes" % (n_lanes, n_takes))
    expert_qpos = expert.qpos.cpu().numpy()

    if not args.gt_init:
        em_cfg = EgoMimicConfig(cfg.ego_mimic_cfg, create_dirs=False)
        em_iter = args.em_iter if args.em_iter is not None \
            else (cfg.ego_mimic_iter or 0)
        em_path = "%s/iter_%04d_%s.p" % (em_cfg.result_dir, em_iter,
                                         args.data)
        if not os.path.exists(em_path):
            raise SystemExit(
                f"estimation results not found at {em_path}; run "
                "ego_mimic_eval first (or pass --gt-init)")
        with open(em_path, "rb") as f:
            em_res, _ = pickle.load(f)
        logger.info("initializing windows from estimation results %s"
                    % em_path)
        init_qpos, init_qvel, margin_rows = em_init_rows(
            em_res, em_cfg.fr_margin, takes, expert_qpos, lane_take,
            lane_start, m, test_len, p.nq, p.nv)

    lt = torch.as_tensor(lane_take, device=device)
    ls = torch.as_tensor(lane_start, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    st = envs.reset(model, p, tables, expert, gen, n_lanes,
                    fix_expert_ind=lt, fix_start_ind=ls)
    if not args.gt_init:
        qp = torch.as_tensor(init_qpos).to(device=device, dtype=dtype)
        bq = envs.get_body_quat(tables, qp)
        st = st._replace(
            qpos=qp, qvel=torch.as_tensor(init_qvel).to(device=device,
                                                         dtype=dtype),
            prev_qpos=qp, prev_bquat=bq, bquat=bq)
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(cfg.seed)
    vs_net = agent.policy_vs_net

    rec_q, rec_fail = [], []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    with torch.no_grad():
        v_out = vs_net.encode_video(gather_past_windows(
            agent.cnn_feat, lt, ls, m))
        s_carry = vs_net.s_init_carry((n_lanes,), v_out)
        for t in range(test_len):
            rec_q.append(st.qpos)
            zobs = running_norm.apply(agent.zstat, envs.observe(p, st),
                                      clip=5.0)
            s_carry, s_out = vs_net.s_step(s_carry, zobs)
            action, log_std = agent.policy_net(torch.cat([v_out, s_out], -1))
            if args.show_noise:
                action = action + torch.exp(log_std) * torch.randn(
                    action.shape, generator=noise_gen, device=device,
                    dtype=dtype)
            new_st, out = envs.step(model, p, tables, expert, st, action)
            rec_fail.append(out.fail)
            if step_hook is not None:
                step_hook(t, st, action, new_st)
            st = new_st
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    n_frames = n_lanes * test_len
    logger.info("forecast rollout: %d windows x %d steps on %s, %.2fs = "
                "%.0f frames/s" % (n_lanes, test_len, device, wall,
                                   n_frames / max(wall, 1e-9)))

    qpos_traj = torch.stack(rec_q).cpu().numpy()           # (T, L, nq)
    fails = torch.stack(rec_fail).cpu().numpy()
    n_fail = int(fails.sum())
    logger.info("window failures: %d" % n_fail)
    if args.verbose:
        for li in np.where(fails.any(axis=0))[0]:
            logger.info("fail - expert_ind: %d, start_ind %d"
                        % (lane_take[li], lane_start[li]))

    traj_pred, traj_orig = {}, {}
    for i in range(n_takes):
        sel = np.where(lane_take == i)[0]
        if len(sel) == 0:           # take filtered out by --expert-ind
            continue
        preds, origs = [], []
        for li in sel:
            s = lane_start[li]
            past = expert_qpos[i, s - m:s] if args.gt_init \
                else margin_rows[li]
            preds.append(np.vstack([past, qpos_traj[:, li]]))
            origs.append(expert_qpos[i, s - m:s + test_len])
        take = takes[i] if i < len(takes) else f"take_{i}"
        traj_pred[take] = np.stack(preds)
        traj_orig[take] = np.stack(origs)
        logger.info("%s %s" % (take, traj_pred[take].shape))

    results = {"traj_pred": traj_pred, "traj_orig": traj_orig}
    meta = {"algo": "ego_forecast", "num_fail": n_fail,
            "n_windows": n_lanes, "wall_s": wall,
            "frames_per_sec": n_frames / max(wall, 1e-9),
            "device": str(device)}
    os.makedirs(cfg.result_dir, exist_ok=True)
    res_path = "%s/iter_%04d_%s%s.p" % (cfg.result_dir, args.iter, args.data,
                                        "_gt" if args.gt_init else "")
    with open(res_path, "wb") as f:
        pickle.dump((results, meta), f)
    logger.info("saved results to %s" % res_path)
    return results, meta


if __name__ == "__main__":
    main()
