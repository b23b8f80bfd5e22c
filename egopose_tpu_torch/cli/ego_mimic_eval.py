"""Ego-mimic evaluation: the product inference path (counterpart of
egopose_tpu/cli/ego_mimic_eval.py).

Rolls the trained policy (mean actions) through every test take at once --
the takes are the batch -- with the value-based fail-safe re-anchoring a
take to the state prediction when the critic signals failure.  The state
prediction is the trained state-regression net's (``state_net_cfg`` /
``state_net_iter``, its results/statereg/<cfg>/models/iter_%04d_inf.p)
where that checkpoint exists, else the ground-truth kinematic state.  Each step
runs all takes through ``envs.step``, whose physics is one launch of the
CUDA control-step kernel on the card.  ``--engine mujoco`` steps the
physics on the MuJoCo C oracle on the host instead (envs/mujoco_oracle.py:
the cross-engine check; no kernel launches), with the same policy,
fail-safe and bookkeeping.

    python -m egopose_tpu_torch.cli.ego_mimic_eval --cfg subject_03 \\
        --synthetic --iter 3000 [--device cuda|cpu] [--f64] \\
        [--engine mujoco] [--render] [--profile-dir DIR]

Writes results/egomimic/<cfg>/results/iter_%04d_<data>[_tags].p as
(results, meta) with results {traj_pred, traj_orig, vel_pred[,
traj_orig_synced]} keyed by take, the JAX package's layout (tag ``_mj``
under ``--engine mujoco``); ``--render`` also writes the viewer's replay
iter_%04d_<data>_replay.npz (utils/render.py::save_replay), and
``--profile-dir`` a torch.profiler trace of the rollout (trace.json).

``--sp-devices M`` time-shards the full-take context encodes over M ranks
(parallel/seqpar.py; TCN context nets only, and ``--causal`` only with
causal ones, whose full pass is their causal encode), and the state net's
forward too where its temporal net is a TCN.  The CLI starts the M ranks
itself (parallel/mesh.py); the lead rank runs the rollout and writes the
results, the others end after the encodes.
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle
import time

import numpy as np
import torch


def kinematic_state_pred(expert, take_idx):
    """State prediction when no trained state net exists: the ground-truth
    kinematic state in the statereg layout (de-headed qpos[2:] ++
    heading-frame finite-difference qvel), (T, nq-2+nv)."""
    from ..ops import math_utils as M
    qpos = expert.qpos[take_idx]
    qvel_fd = M.get_qvel_fd(qpos[:-1], qpos[1:], 1 / 30.0, "heading")
    qvel_fd = torch.cat([qvel_fd, qvel_fd[-1:]], 0)
    pos = torch.cat([qpos[:, 2:3], M.de_heading(qpos[:, 3:7]), qpos[:, 7:]],
                    1)
    return torch.cat([pos, qvel_fd], 1)


def state_net_pred(cfg, cnn_feat, device, dtype, mesh=None):
    """The trained state-regression net's predictions over every take
    (B, T, nq-2+nv), de-normalised with its checkpoint's mean and std: the
    no_cnn VideoRegNet of ``cfg.state_net_model`` (either package's layout
    or the reference's) run over the full takes' CNN features, time-sharded
    over ``mesh`` when its temporal net is a TCN."""
    from ..models import torch_import as ti
    from ..models.video_reg_net import VideoRegNet
    from ..utils.config import StateRegConfig
    model_cp, meta = ti.tolerant_pickle_load(cfg.state_net_model)
    sr_cfg = StateRegConfig(cfg.state_net_cfg, create_dirs=False)
    sd, mean, std = ti.maybe_import_statereg(
        model_cp, meta, cnn_type=sr_cfg.cnn_type, v_net_type=sr_cfg.v_net,
        causal=sr_cfg.causal, no_cnn=True)
    net = VideoRegNet(mean.size, sr_cfg.v_hdim, sr_cfg.cnn_fdim, no_cnn=True,
                      mlp_dim=tuple(sr_cfg.mlp_dim), cnn_type=sr_cfg.cnn_type,
                      v_net_type=sr_cfg.v_net,
                      v_net_param=sr_cfg.v_net_param, causal=sr_cfg.causal)
    net.to(device=device, dtype=dtype).eval()
    net.load_state_dict(sd)
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64),
                                    device=device)
    with torch.no_grad():
        feats = f64(cnn_feat).to(dtype).transpose(0, 1)     # (T, B, F)
        if mesh is not None and net.v_net_type == "tcn":
            from ..parallel.seqpar import vregnet_apply_sp
            pred = vregnet_apply_sp(mesh, net, feats)
        else:
            pred = net(feats)
        pred = pred.transpose(0, 1)                         # (B, T, D)
    # de-normalised in float64, as the JAX package does it in numpy
    return (pred.double() * f64(std) + f64(mean)).to(dtype)


def reset_to_pred(p, tables, st, pred_row):
    """``st`` (EnvState) re-anchored to the predicted states ``pred_row``
    (B, nq-2+nv, the statereg layout), aligned to the sim's xy and
    heading."""
    from .. import envs
    from ..ops import math_utils as M
    from ..ops import quat as Q
    ref = st.qpos
    nq = p.nq
    qpos = torch.cat([ref[:, :2], pred_row[:, :nq - 2]], 1)
    qvel = pred_row[:, nq - 2:].clone()
    hq = M.get_heading_q(ref[:, 3:7])
    qpos[:, 3:7] = Q.quat_mul(hq, qpos[:, 3:7])
    qvel[:, :3] = Q.quat_rotate(hq, qvel[:, :3])
    bq = envs.get_body_quat(tables, qpos)
    return st._replace(qpos=qpos, qvel=qvel, prev_qpos=qpos,
                       prev_bquat=bq, bquat=bq)


def _select(mask, a, b):
    """Per-lane choice between two EnvStates (or tensors)."""
    if isinstance(a, tuple):
        return type(a)(*[_select(mask, x, y) for x, y in zip(a, b)])
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def main(argv=None, step_hook=None, phys_hook=None):
    """``step_hook(t)``, if given, is called after each step t of the timed
    rollout loop (to time or profile a window of steady-state steps);
    ``phys_hook(t, state, action, new_state)`` after each step's physics,
    before the fail-safe."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--render", action="store_true", default=False)
    parser.add_argument("--iter", type=int, default=0)
    parser.add_argument("--expert-ind", type=int, default=-1)
    parser.add_argument("--sync", action="store_true", default=False)
    parser.add_argument("--causal", action="store_true", default=False)
    parser.add_argument("--data", default="test")
    parser.add_argument("--show-noise", action="store_true", default=False)
    parser.add_argument("--fail-safe", default="valuefs",
                        choices=["valuefs", "naivefs", "nofs"])
    parser.add_argument("--synthetic", action="store_true", default=False)
    parser.add_argument("--f64", action="store_true", default=False,
                        help="evaluate in float64 (parity runs); default f32")
    parser.add_argument("--engine", default="torch",
                        choices=["torch", "mujoco"])
    parser.add_argument("--profile-dir", default=None)
    parser.add_argument("--sp-devices", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without "
                             "CUDA), cpu runs the plain PyTorch path")
    args = parser.parse_args(argv)

    from .. import envs, resolve_device
    from ..ops import math_utils as M
    from ..ops import quat as Q
    from ..ops import running_norm
    from ..physics import substep
    from ..rl.agent_ego import AgentEgo
    from ..utils.config import EgoMimicConfig
    from ..utils.log import create_logger
    from ..utils.profile import profiled
    from .ego_mimic import build_world

    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = EgoMimicConfig(args.cfg, create_dirs=False)
    mesh = None
    if args.sp_devices is not None:
        from ..parallel import mesh as meshlib
        from ..parallel.seqpar import vsnet_encode_sp
        for who in ("policy", "value"):
            if getattr(cfg, f"{who}_v_net") != "tcn":
                raise ValueError(
                    "sequence-parallel context encoding requires a TCN "
                    f"context net (got {getattr(cfg, who + '_v_net')!r}: "
                    "recurrent nets are sequential in time)")
        if args.causal and not cfg.causal:
            raise SystemExit("--sp-devices with --causal requires a "
                             "causal context net (causal: true)")
        if not meshlib.in_ranks():
            if device.type == "cuda" and args.engine == "torch":
                substep.build()       # once, before the ranks start
            return meshlib.run_cli(args.sp_devices, main, argv, step_hook,
                                   phys_hook, device=device)
        mesh = meshlib.make_mesh(args.sp_devices, device=device)
        device = mesh.device
    logger = create_logger(os.path.join(cfg.log_dir, "log_eval.txt"),
                           file_handle=mesh is None or mesh.lead)
    if mesh is not None and not mesh.lead:
        logger.setLevel(logging.WARNING)
    np.random.seed(cfg.seed)

    t0 = time.time()
    if device.type == "cuda" and args.engine == "torch":
        substep.build()               # nvcc at first use, outside the loop
    t_build = time.time() - t0

    spec, model, tables, p, expert, cnn_feat = build_world(
        cfg, dtype, device, synthetic=args.synthetic, data=args.data)
    takes = cfg.takes[args.data] if cfg.takes[args.data] else \
        [f"take_{i}" for i in range(expert.qpos.shape[0])]
    if args.expert_ind >= 0:
        i0 = args.expert_ind
        expert = type(expert)(*[x[i0:i0 + 1] for x in expert])
        cnn_feat = cnn_feat[i0:i0 + 1]
        takes = [takes[i0] if i0 < len(takes) else f"take_{i0}"]
    agent = AgentEgo(model, spec, p, tables, expert, cnn_feat, cfg,
                     batch_lanes=expert.qpos.shape[0], seed=cfg.seed,
                     dtype=dtype, device=device)
    cp_path = "%s/iter_%04d.p" % (cfg.model_dir, args.iter)
    if os.path.exists(cp_path):
        logger.info("loading policy net from checkpoint: %s" % cp_path)
        agent.load(cp_path)
    else:
        logger.info("no checkpoint at %s -- evaluating untrained policy"
                    % cp_path)

    n_takes = expert.qpos.shape[0]
    m = cfg.fr_margin
    test_lens = (expert.lens - 2 * m).cpu().numpy()
    t_max = int(test_lens.max())
    test_lens_t = torch.as_tensor(test_lens, device=device)

    if getattr(cfg, "state_net_cfg", None) and \
            os.path.exists(getattr(cfg, "state_net_model", "")):
        state_preds = state_net_pred(cfg, cnn_feat, device, dtype, mesh)
        logger.info("loaded state net from %s" % cfg.state_net_model)
    else:
        state_preds = torch.stack([kinematic_state_pred(expert, i)
                                   for i in range(n_takes)])

    with torch.no_grad():
        feats = torch.as_tensor(cnn_feat).to(device=device, dtype=dtype)
        if mesh is not None:
            # a causal TCN's causal encode is its full pass
            v_out_p = vsnet_encode_sp(mesh, agent.policy_vs_net, feats)
            v_out_v = vsnet_encode_sp(mesh, agent.value_vs_net, feats)
        elif args.causal:
            v_out_p = agent.policy_vs_net.causal_encode(feats)
            v_out_v = agent.value_vs_net.causal_encode(feats)
        else:
            v_out_p = agent.policy_vs_net(feats)
            v_out_v = agent.value_vs_net(feats)

    if mesh is not None and not mesh.lead:
        return None                   # the lead rank runs the rollout
    take_idx = torch.arange(n_takes, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    st = envs.reset(model, p, tables, expert, gen, n_takes,
                    fix_expert_ind=take_idx, fix_start_ind=m)
    st = reset_to_pred(p, tables, st, state_preds[:, m])
    fix_head_lb = 0.3 if args.fail_safe == "naivefs" else None
    sync_interval = int(getattr(cfg, "sync_exp_interval", 100))
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(cfg.seed)
    if args.engine == "mujoco":
        from ..envs.mujoco_oracle import MuJoCoOracle
        oracle = MuJoCoOracle(spec, n_takes, p.jkp, p.jkd, p.torque_lim,
                              frame_skip=int(p.frame_skip))

        def phys_step(st, action):
            qp, qv = oracle.control_step(st.qpos, st.qvel,
                                         envs.apply_action(p, action))
            as_t = lambda x: torch.as_tensor(x).to(device=device,
                                                   dtype=dtype)
            return envs.finish_step(model, p, tables, expert, st, as_t(qp),
                                    as_t(qv), 0.0, fix_head_lb=fix_head_lb)
    else:
        def phys_step(st, action):
            return envs.step(model, p, tables, expert, st, action, 0.0,
                             fix_head_lb=fix_head_lb)

    vstat_n = torch.zeros(n_takes, dtype=dtype, device=device)
    vstat_mean = torch.zeros(n_takes, dtype=dtype, device=device)
    n_reset = torch.zeros(n_takes, dtype=torch.int64, device=device)
    rel_h = torch.tensor([1.0, 0, 0, 0], dtype=dtype,
                         device=device).repeat(n_takes, 1)
    start_p = torch.zeros(n_takes, 3, dtype=dtype, device=device)
    sim_p = torch.zeros(n_takes, 3, dtype=dtype, device=device)
    rec_q, rec_v, rec_r, rec_sync = [], [], [], []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    with torch.no_grad(), profiled(args.profile_dir, device, logger):
        for t in range(t_max):
            active = t < test_lens_t
            e_qpos_t = expert.qpos[:, m + t]
            if t % sync_interval == 0:
                # sync_expert: re-anchor the expert's heading/xy to the sim
                rel_h = Q.quat_mul(M.get_heading_q(st.qpos[:, 3:7]),
                                   Q.quat_inv(M.get_heading_q(
                                       e_qpos_t[:, 3:7])))
                start_p = e_qpos_t[:, :3]
                sim_p = torch.cat([st.qpos[:, :2], e_qpos_t[:, 2:3]], 1)
            rec_sync.append(torch.cat([
                Q.quat_rotate(rel_h, e_qpos_t[:, :3] - start_p) + sim_p,
                Q.quat_mul(rel_h, e_qpos_t[:, 3:7]), e_qpos_t[:, 7:]], 1))
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

            new_st, out = phys_step(st, action)
            if phys_hook is not None:
                phys_hook(t, st, action, new_st)
            if args.fail_safe == "valuefs":
                trigger = value < 0.6 * vstat_mean
            elif args.fail_safe == "naivefs":
                trigger = out.fail
            else:
                trigger = torch.zeros_like(active)
            trigger = trigger & active & (t + 1 < test_lens_t)
            resetted = reset_to_pred(p, tables, new_st,
                                     state_preds[:, m + t + 1])
            new_st = _select(trigger, resetted, new_st)
            st = _select(active, new_st, st)        # frozen once inactive
            n_reset = n_reset + trigger.to(torch.int64)
            rec_r.append(out.reward)
            if step_hook is not None:
                step_hook(t)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    n_frames = int(test_lens.sum())
    logger.info("eval rollout: %d frames over %d takes on %s -- kernel "
                "build %.2fs, execute %.2fs = %.0f frames/s"
                % (n_frames, n_takes, device, t_build, wall,
                   n_frames / max(wall, 1e-9)))

    to_np = lambda xs: torch.stack(xs).cpu().numpy()   # (T, B, ...)
    qpos_traj, qvel_traj = to_np(rec_q), to_np(rec_v)
    rewards, sync_traj = to_np(rec_r), to_np(rec_sync)
    n_reset = n_reset.cpu().numpy()
    expert_qpos = expert.qpos.cpu().numpy()
    traj_pred, traj_orig, vel_pred, orig_sync, avg_reward = {}, {}, {}, {}, {}
    for i in range(n_takes):
        take = takes[i] if i < len(takes) else f"take_{i}"
        tl = int(test_lens[i])
        traj_pred[take] = qpos_traj[:tl, i]
        vel_pred[take] = qvel_traj[:tl, i]
        traj_orig[take] = expert_qpos[i, m:m + tl]
        orig_sync[take] = sync_traj[:tl, i]
        avg_reward[take] = float(rewards[:tl, i].mean())
        logger.info("take %s: len %d resets %d avg reward %.4f"
                    % (take, tl, n_reset[i], avg_reward[take]))

    results = {"traj_pred": traj_pred, "traj_orig": traj_orig,
               "vel_pred": vel_pred}
    if args.sync:
        results["traj_orig_synced"] = orig_sync
    if args.render:
        from ..utils.render import save_replay
        vis_path = "%s/iter_%04d_%s_replay.npz" % (cfg.result_dir, args.iter,
                                                   args.data)
        os.makedirs(cfg.result_dir, exist_ok=True)
        save_replay(vis_path, traj_pred,
                    orig_sync if args.sync else traj_orig)
        logger.info("saved replay for the viewer to %s" % vis_path)
    meta = {"algo": "ego_mimic", "num_reset": int(n_reset.sum()),
            "frames_per_sec": n_frames / max(wall, 1e-9),
            "compile_s": t_build, "engine": args.engine,
            "device": str(device), "steps": t_max,
            "avg_reward": avg_reward}
    fs_tag = "" if args.fail_safe == "valuefs" else "_" + args.fail_safe
    c_tag = "_causal" if args.causal else ""
    e_tag = "_mj" if args.engine == "mujoco" else ""
    res_path = "%s/iter_%04d_%s%s%s%s.p" % (cfg.result_dir, args.iter,
                                            args.data, fs_tag, c_tag, e_tag)
    os.makedirs(cfg.result_dir, exist_ok=True)
    with open(res_path, "wb") as f:
        pickle.dump((results, meta), f)
    logger.info("num reset: %d" % int(n_reset.sum()))
    logger.info("saved results to %s" % res_path)
    return results, meta


if __name__ == "__main__":
    main()
