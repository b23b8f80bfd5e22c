"""Forecast metrics over an ego-forecast results pickle (counterpart of
egopose_tpu/cli/eval_forecast.py): pose, velocity and acceleration
metrics of the sliding windows at horizons 30 and 90.

    python -m egopose_tpu_torch.cli.eval_forecast \\
        --egoforecast-cfg subject_03_syn --egoforecast-iter N [--suffix _gt]

``--mode vis`` opens the TrajectoryViewer on the windows (q/e steps the
window, z/c the take); headless it writes the first take's first window
and its ground truth as a video next to the results pickle (.mp4, or .npz
without a renderer or encoder) and returns its path.
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np


def compute_metrics(results, algo, horizon, fr_margin, dt=1.0 / 30.0,
                    verbose=True):
    """(pose dist, vel dist, mean |accel|) over the first ``horizon``
    forecast frames of every window: averaged over a take's windows, then
    over takes."""
    from ..utils import metrics as mt
    if results is None:
        return None
    if verbose:
        print("=" * 10 + " %s " % algo + "=" * 10)
    g_pose = g_vel = g_smooth = 0.0
    traj_orig, traj_pred = results["traj_orig"], results["traj_pred"]
    for take in traj_pred.keys():
        t_pose = t_vel = t_smooth = 0.0
        n_win = traj_orig[take].shape[0]
        for i in range(n_win):
            traj = traj_pred[take][i, fr_margin:fr_margin + horizon]
            traj_gt = traj_orig[take][i, fr_margin:fr_margin + horizon]
            vels = mt.get_joint_vels(traj, dt)
            t_pose += mt.get_mean_dist(mt.get_joint_angles(traj),
                                       mt.get_joint_angles(traj_gt))
            t_vel += mt.get_mean_dist(vels, mt.get_joint_vels(traj_gt, dt))
            t_smooth += mt.get_mean_abs(mt.get_joint_accels(vels, dt))
        t_pose, t_vel, t_smooth = t_pose / n_win, t_vel / n_win, \
            t_smooth / n_win
        if verbose:
            print("%s - horizon: %d, pose dist: %.4f, vel dist: %.4f, "
                  "accels: %.4f" % (take, horizon, t_pose, t_vel, t_smooth))
        g_pose += t_pose
        g_vel += t_vel
        g_smooth += t_smooth
    n = len(traj_pred)
    g_pose, g_vel, g_smooth = g_pose / n, g_vel / n, g_smooth / n
    if verbose:
        print("-" * 60)
        print("all - horizon: %d, pose dist: %.4f, vel dist: %.4f, "
              "accels: %.4f" % (horizon, g_pose, g_vel, g_smooth))
        print("-" * 60 + "\n")
    return g_pose, g_vel, g_smooth


def compute_err_vs_h(results, algo, horizon, fr_margin, step=10):
    """Pose dist at horizons step, 2 step, ... below ``horizon``."""
    errors = np.array([compute_metrics(results, algo, h, fr_margin,
                                       verbose=False)[0]
                       for h in range(step, horizon, step)])
    print(algo, np.array2string(errors,
                                formatter={"all": lambda x: "%.4f" % x},
                                separator=", "))
    return errors


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--egoforecast-cfg", default=None)
    parser.add_argument("--egoforecast-iter", type=int, default=0)
    parser.add_argument("--data", default="test")
    parser.add_argument("--suffix", default="")
    parser.add_argument("--mode", default="stats", choices=["stats", "vis"])
    parser.add_argument("--multi", action="store_true", default=False,
                        help="vis: time-staggered multi-window puppeting")
    parser.add_argument("--vis-model", default="humanoid_1205_vis_ghost_v1")
    parser.add_argument("--multi-vis-model",
                        default="humanoid_1205_vis_forecast_v1")
    args = parser.parse_args(argv)

    from ..utils.config import EgoForecastConfig
    from ..utils.tools import remove_noisy_hands

    cfg = EgoForecastConfig(args.egoforecast_cfg, create_dirs=False)
    res_path = "results/egoforecast/%s/results/iter_%04d_%s%s.p" % (
        args.egoforecast_cfg, args.egoforecast_iter, args.data, args.suffix)
    with open(res_path, "rb") as f:
        results, meta = pickle.load(f)
    remove_noisy_hands(results)
    if args.mode == "stats":
        return {"horizon_30": compute_metrics(results, "ego forecast", 30,
                                              cfg.fr_margin),
                "horizon_90": compute_metrics(results, "ego forecast", 90,
                                              cfg.fr_margin)}
    algos = [("ego forecast",
              {take: {"pred": results["traj_pred"][take],
                      "orig": results["traj_orig"][take]}
               for take in results["traj_pred"]})]
    from ..utils.assets import find_model_xml
    xml = find_model_xml(
        args.multi_vis_model if args.multi else args.vis_model)
    try:
        from ..envs.visual import TrajectoryViewer
        TrajectoryViewer(xml, algos).run()
        return None
    except Exception as e:
        print("no display (%s) -- writing video instead" % e)
    from ..utils.render import render_qpos_video
    take = list(results["traj_pred"].keys())[0]
    written = render_qpos_video([results["traj_pred"][take][0],
                                 results["traj_orig"][take][0]],
                                res_path.replace(".p", ".mp4"))
    print("wrote %s" % written)
    return written


if __name__ == "__main__":
    main()
