"""Pose-estimation metrics over an ego-mimic or state-regression results
pickle (counterpart of egopose_tpu/cli/eval_pose.py).

    python -m egopose_tpu_torch.cli.eval_pose --egomimic-cfg CFG \
        --egomimic-iter N [--data test] [--tag T]
    python -m egopose_tpu_torch.cli.eval_pose --algo state_reg \
        --statereg-cfg CFG --statereg-iter N [--data test]

``--mode vis`` opens the TrajectoryViewer on the result set (keys 1 / 2
pick ego mimic / state reg, whose results ``--statereg-cfg`` adds), with
``--vis-model`` or, under ``--multi``, ``--multi-vis-model``; headless it
writes the first take's prediction and ground truth as a video next to
the results pickle (.mp4, or .npz without a renderer or encoder)."""
from __future__ import annotations

import argparse
import pickle

import numpy as np


def compute_stats(results, dt=1.0 / 30.0, logger=None):
    """Pose / velocity distance and smoothness per take and overall."""
    from ..utils import metrics as mt
    from ..utils.tools import remove_noisy_hands

    remove_noisy_hands(results)
    traj_pred, traj_orig = results["traj_pred"], results["traj_orig"]
    p_dists, v_dists, p_accels = [], [], []
    per_take = {}
    for take in traj_pred:
        tp, to = traj_pred[take], traj_orig[take]
        n = min(tp.shape[0], to.shape[0])
        tp, to = tp[:n], to[:n]
        vels_pred = mt.get_joint_vels(tp, dt)
        p_dist = mt.get_mean_dist(mt.get_joint_angles(tp),
                                  mt.get_joint_angles(to))
        v_dist = mt.get_mean_dist(vels_pred, mt.get_joint_vels(to, dt))
        p_accel = mt.get_mean_abs(mt.get_joint_accels(vels_pred, dt))
        per_take[take] = dict(pose_dist=p_dist, vel_dist=v_dist,
                              accel=p_accel)
        p_dists.append(p_dist)
        v_dists.append(v_dist)
        p_accels.append(p_accel)
        if logger:
            logger.info("%s: pose_dist %.4f vel_dist %.4f accel %.4f"
                        % (take, p_dist, v_dist, p_accel))
    stats = dict(pose_dist=float(np.mean(p_dists)),
                 vel_dist=float(np.mean(v_dists)),
                 accel=float(np.mean(p_accels)), per_take=per_take)
    if logger:
        logger.info("overall: pose_dist %.4f vel_dist %.4f accel %.4f"
                    % (stats["pose_dist"], stats["vel_dist"], stats["accel"]))
    return stats


def main(argv=None):
    """Score an ego-mimic (``--algo ego_mimic``) or state-regression
    (``--algo state_reg``) results pickle; returns compute_stats' dict."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--egomimic-cfg", default=None)
    parser.add_argument("--statereg-cfg", default=None)
    parser.add_argument("--mode", default="stats", choices=["stats", "vis"])
    parser.add_argument("--data", default="test")
    parser.add_argument("--egomimic-iter", type=int, default=0)
    parser.add_argument("--statereg-iter", type=int, default=0)
    parser.add_argument("--algo", default="ego_mimic",
                        choices=["ego_mimic", "state_reg"])
    parser.add_argument("--tag", "--egomimic-tag", dest="tag", default="",
                        help="results-file suffix")
    parser.add_argument("--multi", action="store_true", default=False,
                        help="vis: time-staggered multi-humanoid puppeting")
    parser.add_argument("--vis-model", default="humanoid_1205_vis_double_v1")
    parser.add_argument("--multi-vis-model",
                        default="humanoid_1205_vis_multi_v1")
    args = parser.parse_args(argv)

    from ..utils.log import create_logger
    logger = create_logger(None, file_handle=False)
    if args.algo == "ego_mimic":
        res_path = "results/egomimic/%s/results/iter_%04d_%s%s.p" % (
            args.egomimic_cfg, args.egomimic_iter, args.data, args.tag)
    else:
        res_path = "results/statereg/%s/results/iter_%04d_%s%s.p" % (
            args.statereg_cfg, args.statereg_iter, args.data, args.tag)
    with open(res_path, "rb") as f:
        results, meta = pickle.load(f)
    logger.info("loaded results from %s (meta: %s)" % (
        res_path, {k: v for k, v in meta.items() if not hasattr(v, "shape")}))
    if args.mode == "stats":
        return compute_stats(results, logger=logger)
    return show_results(args, results, res_path, logger)


def show_results(args, results, res_path, logger):
    """--mode vis: the viewer over the result set (and the state-reg one
    of ``--statereg-cfg`` beside an ego-mimic set), else a video of the
    first take; returns the path written, None with a display."""
    def to_viewer(res):
        return {take: {"pred": res["traj_pred"][take],
                       "orig": res["traj_orig"].get(take)}
                for take in res["traj_pred"]}

    algos = [("ego mimic" if args.algo == "ego_mimic" else "state reg",
              to_viewer(results))]
    if args.algo == "ego_mimic" and args.statereg_cfg:
        other_path = "results/statereg/%s/results/iter_%04d_%s.p" % (
            args.statereg_cfg, args.statereg_iter, args.data)
        with open(other_path, "rb") as f:
            other, _ = pickle.load(f)
        algos.append(("state reg", to_viewer(other)))
    from ..utils.assets import find_model_xml
    xml = find_model_xml(
        args.multi_vis_model if args.multi else args.vis_model)
    try:
        from ..envs.visual import TrajectoryViewer
        TrajectoryViewer(xml, algos).run()
        return None
    except Exception as e:
        logger.info("no display (%s) -- writing video instead" % e)
    from ..utils.render import render_qpos_video
    take = list(results["traj_pred"].keys())[0]
    written = render_qpos_video([results["traj_pred"][take],
                                 results["traj_orig"][take]],
                                res_path.replace(".p", ".mp4"))
    logger.info("wrote %s" % written)
    return written


if __name__ == "__main__":
    main()
