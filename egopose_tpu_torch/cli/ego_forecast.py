"""Ego-forecast PPO training (counterpart of egopose_tpu/cli/ego_forecast.py):
the same flags, config schema, checkpoint naming
(results/egoforecast/<cfg>/models/iter_%04d.p, the JAX package's pickle
layout), warm start from the ego-mimic checkpoint
results/egomimic/<ego_mimic_cfg>/models/iter_<ego_mimic_iter>.p, adaptive
init-noise schedule and end-reward flag.

    python -m egopose_tpu_torch.cli.ego_forecast --cfg subject_03_syn \\
        --synthetic [--batch-lanes 1024] [--max-iter N] [--iter N] \\
        [--device cuda|cpu]

On the card every control step of the rollout is one launch of the K1
control-step kernel.  Reads config/ and results/egomimic/ and writes
results/egoforecast/ relative to the working directory.
``policy_objective`` (ppo, a2c, trpo) picks the update.  ``--ckpt-format
orbax`` writes the native checkpoint directory models/iter_%04d.orbax,
which ``--iter N`` resumes from when it exists (cli/ego_mimic.py).

``--dp-devices N`` trains data-parallel over N ranks, as ego_mimic's does
(cli/ego_mimic.py).

``--render`` samples with mean actions (sampled ones with
``--show-noise``) and writes no log file and no scalars.
``--profile-dir DIR`` records the set-up and the second iteration under
torch.profiler, as ego_mimic's does, to DIR/setup_trace.json and
DIR/trace.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os

import numpy as np


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
    parser.add_argument("--max-iter", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true", default=False)
    parser.add_argument("--f64", action="store_true", default=False)
    parser.add_argument("--min-batch", type=int, default=None,
                        help="override cfg.min_batch_size (debug)")
    parser.add_argument("--episode-len", type=int, default=None,
                        help="override cfg.env_episode_len (debug)")
    parser.add_argument("--dp-devices", type=int, default=None)
    parser.add_argument("--profile-dir", default=None)
    parser.add_argument("--ckpt-format", default="pickle",
                        choices=("pickle", "orbax"))
    parser.add_argument("--kl-target", type=float, default=None,
                        help="PPO trust-region early stop (config key "
                             "policy_kl_target)")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without "
                             "CUDA), cpu runs the plain PyTorch path")
    args = parser.parse_args(argv)

    import torch
    from .. import resolve_device
    from ..models import torch_import as ti
    from ..parallel import mesh as meshlib
    from ..physics import nvcc
    from ..rl.agent_ego import check_mesh
    from ..rl.agent_forecast import AgentForecast, warmstart_from_mimic
    from ..utils.config import EgoForecastConfig, EgoMimicConfig
    from ..utils.log import ScalarWriter, create_logger
    from ..utils.profile import profiled, span, timed
    from .ego_mimic import build_world, resume, save

    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = EgoForecastConfig(args.cfg,
                            create_dirs=not (args.render or args.iter > 0))
    if args.min_batch is not None:
        cfg.min_batch_size = args.min_batch
    if args.kl_target is not None:
        cfg.policy_kl_target = args.kl_target
    if args.episode_len is not None:
        cfg.env_episode_len = args.episode_len
    mesh = None
    if args.dp_devices is not None:
        check_mesh(cfg, args.batch_lanes, args.dp_devices, 1)
        if not meshlib.in_ranks():
            if device.type == "cuda":
                nvcc.build_all()      # once, before the ranks start
            return meshlib.run_cli(args.dp_devices, main, argv, iter_hook,
                                   device=device)
        mesh = meshlib.make_mesh(args.dp_devices, device=device)
        device = mesh.device
    lead = mesh is None or mesh.lead
    np.random.seed(cfg.seed)
    logger = create_logger(os.path.join(cfg.log_dir, "log.txt"),
                           file_handle=not args.render and lead)
    if not lead:
        logger.setLevel(logging.WARNING)
    tb = None if args.render or not lead else ScalarWriter(cfg.tb_dir)
    setup_trace = contextlib.ExitStack()     # closed when the set-up ends
    setup_trace.enter_context(profiled(lead and args.profile_dir, device,
                                       logger, "setup_trace.json"))
    with span("setup.build_kernels"):
        if device.type == "cuda":
            nvcc.build_all()          # nvcc at first use, outside the loop

    with span("setup.world"):
        spec, model, tables, p, expert, cnn_feat = build_world(
            cfg, dtype, device, synthetic=args.synthetic)
    logger.info(f"device: {device}  lanes: {args.batch_lanes}  "
                f"experts: {tuple(expert.qpos.shape)}")
    with span("setup.checkpoint"):
        agent = AgentForecast(model, spec, p, tables, expert, cnn_feat, cfg,
                              batch_lanes=args.batch_lanes, seed=cfg.seed,
                              dtype=dtype, device=device, mesh=mesh)
        if args.iter > 0:
            resume(agent, cfg.model_dir, args.iter, logger)
        elif cfg.ego_mimic_cfg is not None:
            em_path = "results/egomimic/%s/models/iter_%04d.p" % (
                cfg.ego_mimic_cfg, cfg.ego_mimic_iter or 0)
            if os.path.exists(em_path):
                mimic_cp = ti.tolerant_pickle_load(em_path)
                if ti.looks_torch_state_dict(mimic_cp.get("policy_dict")):
                    em_cfg = EgoMimicConfig(cfg.ego_mimic_cfg,
                                            create_dirs=False)
                    mimic_cp = ti.import_mimic_checkpoint(
                        mimic_cp, bi_dir=not em_cfg.causal,
                        v_net_type=em_cfg.policy_v_net,
                        value_v_net_type=em_cfg.value_v_net)
                copied = warmstart_from_mimic(agent, mimic_cp)
                logger.info("warm start from ego mimic checkpoint: %s (%s)"
                            % (em_path, copied))
            else:
                logger.info("no ego mimic checkpoint at %s, cold start"
                            % em_path)
    setup_trace.close()

    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    max_iter = args.max_iter if args.max_iter is not None \
        else cfg.max_iter_num
    base_p = p
    for i_iter in range(args.iter, max_iter):
        # the second iteration: the first is the warm-up
        profiling = args.profile_dir and i_iter == args.iter + 1 and lead
        with profiled(profiling and args.profile_dir, device,
                      logger), span("iteration", i_iter):
            cfg.update_adaptive_params(i_iter)
            agent.set_noise_rate(cfg.adp_noise_rate)
            agent.set_policy_lr(cfg.adp_policy_lr)
            if cfg.fix_std:
                agent.fill_log_std(cfg.adp_log_std)
            # the episode init noise follows its schedule
            agent.p = dataclasses.replace(
                base_p, env_init_noise=float(cfg.adp_init_noise))

            batch, log = agent.sample(
                generator, cfg.min_batch_size,
                mean_action=args.render and not args.show_noise)
            if cfg.end_reward:
                agent.end_reward = log.avg_c_reward * cfg.gamma \
                    / (1 - cfg.gamma)
            with timed("update") as update:
                metrics = agent.update_params(batch)   # reads losses back
        t_update = update.seconds

        info_str = np.array2string(log.avg_c_info,
                                   formatter={"all": lambda x: "%.4f" % x},
                                   separator=",")
        skips = metrics["policy_grad_skips"] + metrics["value_grad_skips"]
        steps_per_s = log.num_steps / max(log.sample_time, 1e-9)
        logger.info(
            "{}\tT_sample {:.2f}\tT_update {:.2f}\tR_avg {:.4f} {}"
            "\tR_range ({:.4f}, {:.4f})\teps_len_avg {:.2f}"
            "\tP_loss {:.4f}\tV_loss {:.4f}\tsteps/s {:.0f}{}{}"
            .format(i_iter, log.sample_time, t_update, log.avg_c_reward,
                    info_str, log.min_c_reward, log.max_c_reward,
                    log.avg_episode_len, metrics["policy_loss"],
                    metrics["value_loss"], steps_per_s,
                    "\tgrad_skips %d" % skips if skips else "",
                    "\tkl_stop" if metrics.get("kl_stopped") else ""))
        if tb:
            tb.scalar("total_reward", log.avg_c_reward, i_iter)
            tb.scalar("episode_len", log.avg_episode_len, i_iter)
            tb.scalar("env_steps_per_sec", steps_per_s, i_iter)

        if cfg.save_model_interval > 0 \
                and (i_iter + 1) % cfg.save_model_interval == 0:
            save(agent, cfg.model_dir, i_iter + 1, args.ckpt_format, logger)
        if iter_hook is not None:
            iter_hook(i_iter, log, metrics, t_update)

    if tb:
        tb.close()
    logger.info("training done!")
    return agent


if __name__ == "__main__":
    main()
