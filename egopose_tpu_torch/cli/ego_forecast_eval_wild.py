"""In-the-wild forecast evaluation (counterpart of
egopose_tpu/cli/ego_forecast_eval_wild.py, ``--mode save``): sliding-window
forecasting from the wild ego-mimic estimation results, with no ground
truth experts.

Windows start every fr_margin frames across each wild take while the
window stays inside the take and inside its estimation; each rolls the
forecast policy (mean actions) for env_episode_len steps from the
estimated state at its start, conditioned only on the fr_margin past video
frames.  Every window of every take is one lane of a single batch, so each
control step is one launch of the CUDA control-step kernel over all
windows on the card.

    python -m egopose_tpu_torch.cli.ego_forecast_eval_wild \\
        --cfg subject_03_syn --iter N --test-feat wild_01 \\
        [--egomimic-iter M] [--device cuda|cpu] [--f64]

Reads datasets/features/cnn_feat_<test-feat>.p and the estimation results
results/egomimic/<ego_mimic_cfg>/results/iter_%04d_<test-feat>.p; writes
results/egoforecast/<cfg>/results/iter_%04d_<test-feat>.p as (results,
meta) with results {traj_pred: {take: (n_windows, fr_margin +
env_episode_len, nq)}}, the JAX package's layout.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np


def wild_window_lanes(takes, cnn_feat_dict, em_traj, m, em_margin, test_len,
                      test_ind=-1, start_ind=None):
    """(take index, start frame) of every window: starts m, 2m, ... while
    the window's test_len steps stay inside the take's features and inside
    its estimation ``em_traj[take]`` (which begins at frame em_margin);
    ``test_ind`` >= 0 keeps one take's windows, ``start_ind`` the windows
    that start there."""
    lane_take, lane_start = [], []
    for i, take in enumerate(takes):
        if test_ind >= 0 and i != test_ind:
            continue
        take_len = np.asarray(cnn_feat_dict[take]).shape[0]
        est_len = em_traj[take].shape[0]
        start = m
        while start + test_len <= take_len and \
                start - em_margin + test_len <= est_len:
            if start_ind is None or start == start_ind:
                lane_take.append(i)
                lane_start.append(start)
            start += m
    return lane_take, lane_start


def wild_init_rows(em_res, cnn_feat_dict, takes, lane_take, lane_start, m,
                   em_margin):
    """Each window's past CNN frames (n, m, F), initial (qpos, qvel) and m
    past qpos rows from its take's estimation: the estimate at the window
    start (clamped to the estimation's last frame) and the m estimated
    frames before it, the missing ones filled with the initial qpos."""
    n, first = len(lane_take), takes[lane_take[0]]
    nq = em_res["traj_pred"][first].shape[1]
    fdim = np.asarray(cnn_feat_dict[first]).shape[-1]
    past_wins = np.zeros((n, m, fdim), np.float32)
    init_qpos = np.zeros((n, nq))
    init_qvel = np.zeros((n, em_res["vel_pred"][first].shape[1]))
    margin_rows = np.zeros((n, m, nq))
    for li, (i, s) in enumerate(zip(lane_take, lane_start)):
        take = takes[i]
        past_wins[li] = np.asarray(cnn_feat_dict[take][s - m:s])
        est_traj = em_res["traj_pred"][take]
        est_vel = em_res["vel_pred"][take]
        e_ind = max(0, s - em_margin)
        init_qpos[li] = est_traj[min(e_ind, est_traj.shape[0] - 1)]
        init_qvel[li] = est_vel[min(e_ind, est_vel.shape[0] - 1)]
        past = est_traj[max(0, e_ind - m):e_ind]
        if past.shape[0] < m:
            past = np.vstack([np.tile(init_qpos[li],
                                      (m - past.shape[0], 1)), past])
        margin_rows[li] = past
    return past_wins, init_qpos, init_qvel, margin_rows


def main(argv=None, step_hook=None):
    """``step_hook(t, state, action, new_state)``, if given, is called
    after each control step t with the windows' EnvState before and after
    it and the action taken."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--iter", type=int, default=0)
    parser.add_argument("--test-feat", default=None)
    parser.add_argument("--egomimic-iter", type=int, default=None)
    parser.add_argument("--mode", default="save", choices=("save", "vis"))
    parser.add_argument("--f64", action="store_true", default=False,
                        help="evaluate in float64 (parity runs); default f32")
    parser.add_argument("--test-ind", type=int, default=-1,
                        help="restrict to one wild take (default all)")
    parser.add_argument("--start-ind", type=int, default=None,
                        help="restrict to the window starting at this frame")
    parser.add_argument("--show-noise", action="store_true", default=False,
                        help="sampled instead of mean actions")
    parser.add_argument("--render", action="store_true", default=False)
    parser.add_argument("--vis-model",
                        default="humanoid_1205_vis_forecast_v1")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without "
                             "CUDA), cpu runs the plain PyTorch path")
    args = parser.parse_args(argv)
    for flag, on in (("--mode vis", args.mode == "vis"),
                     ("--render", args.render),
                     ("--vis-model", args.vis_model
                      != "humanoid_1205_vis_forecast_v1")):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP §1 item 2)")

    import torch
    from .. import envs, resolve_device
    from ..ops import running_norm
    from ..physics import substep
    from ..rl.agent_forecast import AgentForecast
    from ..utils.config import EgoForecastConfig, EgoMimicConfig
    from ..utils.log import create_logger
    from .ego_mimic import build_world
    from .ego_mimic_eval_wild import load_wild_features

    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = EgoForecastConfig(args.cfg, create_dirs=False)
    logger = create_logger(os.path.join(cfg.log_dir, "log_eval_wild.txt"))
    if device.type == "cuda":
        substep.build()               # nvcc at first use, outside the loop

    cnn_feat_dict = load_wild_features(cfg, args.test_feat)
    takes = list(cnn_feat_dict.keys())
    em_cfg = EgoMimicConfig(cfg.ego_mimic_cfg, create_dirs=False)
    em_iter = args.egomimic_iter if args.egomimic_iter is not None \
        else cfg.ego_mimic_iter
    em_path = "%s/iter_%04d_%s.p" % (em_cfg.result_dir, em_iter,
                                     args.test_feat)
    with open(em_path, "rb") as f:
        em_res, _ = pickle.load(f)
    em_margin = em_cfg.fr_margin

    spec, model, tables, p, expert, _ = build_world(cfg, dtype, device,
                                                    synthetic=True)
    fdim = np.asarray(cnn_feat_dict[takes[0]]).shape[-1]
    agent = AgentForecast(model, spec, p, tables, expert,
                          np.zeros((1, 8, fdim), np.float32), cfg,
                          batch_lanes=1, seed=cfg.seed, dtype=dtype,
                          device=device)
    cp_path = "%s/iter_%04d.p" % (cfg.model_dir, args.iter)
    if os.path.exists(cp_path):
        agent.load(cp_path)
        logger.info("loaded policy from %s" % cp_path)

    m, test_len = cfg.fr_margin, cfg.env_episode_len
    lane_take, lane_start = wild_window_lanes(
        takes, cnn_feat_dict, em_res["traj_pred"], m, em_margin, test_len,
        args.test_ind, args.start_ind)
    n_lanes = len(lane_take)
    logger.info("%d wild forecast windows across %d takes"
                % (n_lanes, len(takes)))
    res_path = "%s/iter_%04d_%s.p" % (cfg.result_dir, args.iter,
                                      args.test_feat)
    os.makedirs(cfg.result_dir, exist_ok=True)
    if n_lanes == 0:
        results = {"traj_pred": {t: np.zeros((0, m + test_len, p.nq))
                                 for t in takes}}
        with open(res_path, "wb") as f:
            pickle.dump((results, {"algo": "ego_forecast"}), f)
        return results, {"algo": "ego_forecast", "n_windows": 0}

    # host-side window assembly: past-video windows, init states, margin rows
    past_wins, init_qpos, init_qvel, margin_rows = wild_init_rows(
        em_res, cnn_feat_dict, takes, lane_take, lane_start, m, em_margin)

    to_dev = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    st = envs.reset(model, p, tables, expert, gen, n_lanes,
                    fix_expert_ind=0, fix_start_ind=p.fr_margin)
    qp = to_dev(init_qpos)
    bq = envs.get_body_quat(tables, qp)
    st = st._replace(qpos=qp, qvel=to_dev(init_qvel), prev_qpos=qp,
                     prev_bquat=bq, bquat=bq)
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(cfg.seed)
    vs_net = agent.policy_vs_net

    rec_q = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    with torch.no_grad():
        v_out = vs_net.encode_video(to_dev(past_wins))
        # the state LSTM's carry in the run's dtype
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
            new_st, _ = envs.step(model, p, tables, expert, st, action, 0.0,
                                  fix_head_lb=-10.0)
            if step_hook is not None:
                step_hook(t, st, action, new_st)
            st = new_st
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    n_frames = n_lanes * test_len
    logger.info("wild forecast rollout: %d windows x %d steps on %s, %.2fs "
                "= %.0f frames/s" % (n_lanes, test_len, device, wall,
                                     n_frames / max(wall, 1e-9)))

    qpos_traj = torch.stack(rec_q).cpu().numpy()           # (T, L, nq)
    lane_take = np.asarray(lane_take)
    traj_pred = {}
    for i, take in enumerate(takes):
        sel = np.where(lane_take == i)[0]
        wins = [np.vstack([margin_rows[li], qpos_traj[:, li]]) for li in sel]
        traj_pred[take] = np.stack(wins) if wins else \
            np.zeros((0, m + test_len, p.nq))
        logger.info("%s %s" % (take, traj_pred[take].shape))

    results = {"traj_pred": traj_pred}
    meta = {"algo": "ego_forecast", "n_windows": n_lanes, "wall_s": wall,
            "frames_per_sec": n_frames / max(wall, 1e-9),
            "device": str(device)}
    with open(res_path, "wb") as f:
        pickle.dump((results, meta), f)
    logger.info("saved results to %s" % res_path)
    return results, meta


if __name__ == "__main__":
    main()
