"""Ego-mimic PPO training (counterpart of egopose_tpu/cli/ego_mimic.py):
the same flags, config schema, checkpoint naming
(results/egomimic/<cfg>/models/iter_%04d.p, the JAX package's pickle
layout), per-iteration log line and adaptive-parameter schedule.  With
``--synthetic`` it trains against synthetic mocap.

    python -m egopose_tpu_torch.cli.ego_mimic --cfg subject_03 --synthetic \
        [--batch-lanes 1024] [--max-iter N] [--iter N] [--device cuda|cpu]

On the card every control step of the rollout is one launch of the K1
control-step kernel (position mode) or 15 launches of the K2 SPD-solve
kernel (``action_type: torque``).  Reads config/ and writes results/
relative to the working directory.  ``policy_objective`` (ppo, a2c, trpo)
picks the update; a ``discriminator:`` block trains with VGAIL
(rl/vgail.py).  ``--ckpt-format orbax`` writes the native checkpoint, with
both optimizers' states, as the directory models/iter_%04d.orbax (the JAX
package's path; it holds the port's own file, not orbax's); ``--iter N``
resumes from that directory when it exists, else from iter_%04d.p.

``--dp-devices N`` trains data-parallel over N ranks (rollout lanes and
update batches split, parameters replicated; rl/agent_ego.py) and
``--sp-devices M`` time-shards the TCN context encodes over M ranks per
lane shard (parallel/seqpar.py): the CLI starts N*M ranks itself
(parallel/mesh.py; under torchrun it joins the running group), rank r on
cuda:r, or gloo ranks with ``--device cpu``.  The lead rank logs and
writes the checkpoints and the render sample.

``--render`` samples one segment (mean actions unless ``--show-noise``)
instead of training and saves its rewards, actions and lanes' experts as
results/egomimic/<cfg>/results/render_iter_%04d.npz.  ``--profile-dir DIR``
records the second iteration's sample and update under torch.profiler,
as the ranges ``sample`` and ``update``, to DIR/trace.json.
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle
import time

import numpy as np


def build_world(cfg, dtype, device, synthetic=False, synthetic_takes=None,
                synthetic_len=None, model_xml=None, data="train"):
    """Physics model + experts + CNN features for a config, on ``device``.

    ``data`` selects the take split whose experts and features load.  The
    synthetic world defaults to 4 takes x 400 frames, overridable with
    EGOPOSE_SYNTHETIC_TAKES / EGOPOSE_SYNTHETIC_LEN; it is drawn from
    np.random.RandomState(cfg.seed) exactly as the JAX package draws it, so
    both packages see the same experts and features."""
    from .. import envs
    from ..physics.model import build_model
    from ..physics.spec import parse_mjcf
    from ..utils.assets import find_model_xml
    from ..utils.config import apply_model_params, make_env_params
    if synthetic_takes is None:
        synthetic_takes = int(os.environ.get("EGOPOSE_SYNTHETIC_TAKES", 4))
    if synthetic_len is None:
        synthetic_len = int(os.environ.get("EGOPOSE_SYNTHETIC_LEN", 400))
    xml = find_model_xml(model_xml or cfg.mujoco_model)
    spec = apply_model_params(parse_mjcf(xml), cfg)
    model = build_model(spec, dtype=dtype, device=device)
    tables = envs.make_body_tables(spec, device)
    obs_dim = (1 if cfg.obs_heading else 0) + (spec.nq - 2) \
        + {"root": 6, "full": spec.ndof}.get(cfg.obs_vel, 0) \
        + (1 if cfg.obs_phase else 0)
    p = make_env_params(cfg, spec, obs_dim=obs_dim, dtype=dtype,
                        device=device)

    if not synthetic and cfg.expert_feat_file \
            and os.path.exists(cfg.expert_feat_file):
        with open(cfg.expert_feat_file, "rb") as f:
            expert_dict = pickle.load(f)
        expert = envs.stack_experts([expert_dict[t] for t in cfg.takes[data]],
                                    device=device)
        with open(cfg.cnn_feat_file, "rb") as f:
            cnn = pickle.load(f)
        cnn_feat_dict = cnn[0] if isinstance(cnn, tuple) else cnn
        feats = [np.asarray(cnn_feat_dict[t]) for t in cfg.takes[data]]
        tmax = int(expert.qpos.shape[1])
        cnn_feat = np.zeros((len(feats), tmax, feats[0].shape[-1]),
                            np.float32)
        for i, f in enumerate(feats):
            n = min(tmax, f.shape[0])
            cnn_feat[i, :n] = f[:n]
            cnn_feat[i, n:] = f[n - 1]
    else:
        expert = envs.synthetic_experts(model, p, tables, spec,
                                        n_takes=synthetic_takes,
                                        t_len=synthetic_len, seed=cfg.seed)
        rng = np.random.RandomState(cfg.seed)
        # synthetic "CNN features": noisy linear projection of expert obs
        proj = rng.randn(expert.obs.shape[-1], 64).astype(np.float32) / 8
        obs = expert.obs.detach().cpu().numpy().astype(np.float32)
        cnn_feat = np.einsum("etf,fc->etc", obs, proj)
        cnn_feat += 0.1 * rng.randn(*cnn_feat.shape).astype(np.float32)
    expert = type(expert)(*[x.to(dtype) if x.is_floating_point() else x
                            for x in expert])
    return spec, model, tables, p, expert, np.asarray(cnn_feat)


def main(argv=None, iter_hook=None):
    """Train; returns the agent.  ``iter_hook(i_iter, log, metrics,
    t_update)``, if given, is called after each iteration."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--render", action="store_true", default=False)
    parser.add_argument("--num-threads", type=int, default=12,
                        help="accepted for CLI parity; lanes come from "
                             "--batch-lanes")
    parser.add_argument("--gpu-index", type=int, default=0,
                        help="accepted for CLI parity (see --device)")
    parser.add_argument("--iter", type=int, default=0)
    parser.add_argument("--show-noise", action="store_true", default=False)
    parser.add_argument("--batch-lanes", type=int, default=1024)
    parser.add_argument("--dp-devices", type=int, default=None)
    parser.add_argument("--sp-devices", type=int, default=None)
    parser.add_argument("--max-iter", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true", default=False)
    parser.add_argument("--f64", action="store_true", default=False)
    parser.add_argument("--min-batch", type=int, default=None,
                        help="override cfg.min_batch_size (debug)")
    parser.add_argument("--episode-len", type=int, default=None,
                        help="override cfg.env_episode_len (debug)")
    parser.add_argument("--profile-dir", default=None)
    parser.add_argument("--ckpt-format", default="pickle",
                        choices=("pickle", "orbax"))
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without "
                             "CUDA), cpu runs the plain PyTorch path")
    args = parser.parse_args(argv)

    import torch
    from .. import resolve_device
    from ..parallel import mesh as meshlib
    from ..physics import nvcc
    from ..rl.agent_ego import AgentEgo, check_mesh
    from ..utils.config import EgoMimicConfig
    from ..utils.log import ScalarWriter, create_logger
    from ..utils.profile import profiled

    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = EgoMimicConfig(args.cfg,
                         create_dirs=not (args.render or args.iter > 0))
    if args.min_batch is not None:
        cfg.min_batch_size = args.min_batch
    if args.episode_len is not None:
        cfg.env_episode_len = args.episode_len
    mesh = None
    if args.dp_devices is not None or args.sp_devices is not None:
        dp, sp = args.dp_devices or 1, args.sp_devices or 1
        check_mesh(cfg, args.batch_lanes, dp, sp)   # before ranks start
        if not meshlib.in_ranks():
            if device.type == "cuda":
                nvcc.build_all()      # once, before the ranks start
            return meshlib.run_cli(dp * sp, main, argv, iter_hook,
                                   device=device)
        mesh = meshlib.make_mesh_2d(dp, sp, device=device) if sp > 1 \
            else meshlib.make_mesh(dp, device=device)
        device = mesh.device
    lead = mesh is None or mesh.lead
    np.random.seed(cfg.seed)
    # --render writes no log file and no scalars; only the lead rank logs
    logger = create_logger(os.path.join(cfg.log_dir, "log.txt"),
                           file_handle=not args.render and lead)
    if not lead:
        logger.setLevel(logging.WARNING)
    tb = None if args.render or not lead else ScalarWriter(cfg.tb_dir)
    if device.type == "cuda":
        nvcc.build_all()              # nvcc at first use, outside the loop

    spec, model, tables, p, expert, cnn_feat = build_world(
        cfg, dtype, device, synthetic=args.synthetic)
    logger.info(f"device: {device}  lanes: {args.batch_lanes}  "
                f"experts: {tuple(expert.qpos.shape)}")
    if args.num_threads != parser.get_default("num_threads"):
        logger.info(f"--num-threads {args.num_threads} accepted for "
                    f"reference CLI parity but has no effect here: sampling "
                    f"runs as {args.batch_lanes} batched device lanes, not "
                    f"host threads (use --batch-lanes to scale)")
    agent_cls = AgentEgo
    if getattr(cfg, "discriminator", None):
        from ..rl.vgail import AgentVGAIL as agent_cls
        logger.info("discriminator block present: training with VGAIL "
                    "reward shaping (reward_weight=%s)"
                    % dict(cfg.discriminator).get("reward_weight", 1.0))
    agent = agent_cls(model, spec, p, tables, expert, cnn_feat, cfg,
                      batch_lanes=args.batch_lanes, seed=cfg.seed,
                      dtype=dtype, device=device, mesh=mesh)
    if args.iter > 0:
        resume(agent, cfg.model_dir, args.iter, logger)

    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    if args.render:
        save_render_sample(agent, generator, cfg, args, logger)
        return agent
    max_iter = args.max_iter if args.max_iter is not None \
        else cfg.max_iter_num
    for i_iter in range(args.iter, max_iter):
        cfg.update_adaptive_params(i_iter)
        agent.set_noise_rate(cfg.adp_noise_rate)
        agent.set_policy_lr(cfg.adp_policy_lr)
        if cfg.fix_std:
            agent.fill_log_std(cfg.adp_log_std)

        # the second iteration: the first is the warm-up
        profiling = args.profile_dir and i_iter == args.iter + 1 and lead
        with profiled(profiling and args.profile_dir, device, logger):
            with torch.profiler.record_function("sample"):
                batch, log = agent.sample(generator, cfg.min_batch_size)
            agent.end_reward = log.avg_c_reward * cfg.gamma \
                / (1 - cfg.gamma)
            t0 = time.time()
            with torch.profiler.record_function("update"):
                metrics = agent.update_params(batch)   # reads losses back
            t_update = time.time() - t0

        info_str = np.array2string(log.avg_c_info,
                                   formatter={"all": lambda x: "%.4f" % x},
                                   separator=",")
        skips = metrics["policy_grad_skips"] + metrics["value_grad_skips"]
        steps_per_s = log.num_steps / max(log.sample_time, 1e-9)
        logger.info(
            "{}\tT_sample {:.2f}\tT_update {:.2f}\tR_avg {:.4f} {}"
            "\tR_range ({:.4f}, {:.4f})\teps_len_avg {:.2f}\tsteps/s {:.0f}{}{}"
            .format(i_iter, log.sample_time, t_update, log.avg_c_reward,
                    info_str, log.min_c_reward, log.max_c_reward,
                    log.avg_episode_len, steps_per_s,
                    "\tgrad_skips %d" % skips if skips else "",
                    "\tdiscrim_loss %.4f" % metrics["discrim_loss"]
                    if "discrim_loss" in metrics else ""))
        if tb:
            tb.scalar("total_reward", log.avg_c_reward, i_iter)
            tb.scalar("episode_len", log.avg_episode_len, i_iter)
            tb.scalar("env_steps_per_sec", steps_per_s, i_iter)
            for i in range(log.avg_c_info.shape[0]):
                tb.scalar(f"reward_{i}", log.avg_c_info[i], i_iter)
            if "discrim_loss" in metrics:
                tb.scalar("discrim_loss", metrics["discrim_loss"], i_iter)

        if cfg.save_model_interval > 0 \
                and (i_iter + 1) % cfg.save_model_interval == 0:
            save(agent, cfg.model_dir, i_iter + 1, args.ckpt_format, logger)
        if iter_hook is not None:
            iter_hook(i_iter, log, metrics, t_update)

    if tb:
        tb.close()
    logger.info("training done!")
    return agent


def save(agent, model_dir, i_iter, ckpt_format, logger):
    """The checkpoint of iteration ``i_iter``: models/iter_%04d.p, or with
    ``ckpt_format`` orbax the native directory models/iter_%04d.orbax."""
    if ckpt_format == "orbax":
        cp_path = "%s/iter_%04d.orbax" % (model_dir, i_iter)
        agent.save_native(cp_path)
    else:
        cp_path = "%s/iter_%04d.p" % (model_dir, i_iter)
        agent.save(cp_path)
    logger.info("saved checkpoint %s" % cp_path)


def resume(agent, model_dir, i_iter, logger):
    """Load iteration ``i_iter``'s checkpoint: the native directory when it
    exists (nets, filter and optimizers), else the pickle (nets and
    filter; the optimizers start afresh, as in the JAX package)."""
    native = "%s/iter_%04d.orbax" % (model_dir, i_iter)
    if os.path.isdir(native):
        logger.info("loading model from native checkpoint: %s" % native)
        agent.load_native(native)
    else:
        cp_path = "%s/iter_%04d.p" % (model_dir, i_iter)
        logger.info("loading model from checkpoint: %s" % cp_path)
        agent.load(cp_path)


def save_render_sample(agent, generator, cfg, args, logger):
    """--render: one sampled segment, mean actions unless --show-noise,
    saved as results/.../render_iter_%04d.npz (per-step rewards, actions
    and each step's lane expert and start frame).  On a mesh each rank
    samples its lanes; the lanes are gathered in the one-process order and
    the lead rank writes them."""
    from ..parallel import mesh as meshlib
    batch, log = agent.sample(generator, cfg.min_batch_size,
                              mean_action=not args.show_noise)
    logger.info("render sample: %d steps, R_avg %.4f"
                % (log.num_steps, log.avg_c_reward))
    fields = {k: getattr(batch, k)
              for k in ("rewards", "actions", "expert_ind", "start_ind")}
    if agent.mesh is not None:
        axis = agent.data.axis
        segments = batch.expert_ind.shape[0] * agent.mesh.size(axis) \
            // agent.batch_lanes
        fields = {k: meshlib.gather_lanes(agent.mesh, x, axis,
                                          1 if x.dim() > 1 else 0, segments)
                  for k, x in fields.items()}
    out = "%s/render_iter_%04d.npz" % (cfg.result_dir, args.iter)

    def write():
        os.makedirs(cfg.result_dir, exist_ok=True)
        np.savez_compressed(out, **{k: x.cpu().numpy()
                                    for k, x in fields.items()})
        logger.info("saved rollout sample to %s" % out)

    meshlib.lead_writes(agent.mesh, write)
    return out


if __name__ == "__main__":
    main()
