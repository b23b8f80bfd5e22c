"""Wild forecast metrics (counterpart of
egopose_tpu/cli/eval_forecast_wild.py): the per-horizon 2D keypoint
distance against OpenPose ground truth over the forecast windows, and
their smoothness.

    python -m egopose_tpu_torch.cli.eval_forecast_wild \\
        --egoforecast-cfg subject_03_syn --egoforecast-iter N \\
        --data wild_01 [--horizons 30 90] [--meta-file M] [--device cuda|cpu] \\
        [--mode vis | --stats-vis] [--multi] [--vis-model V]

Every window of a take is projected at once (one batched FK: K5 on the
card) and the projections serve every horizon.  Window ``wi``'s forecast
frame ``fr`` is scored against keypoint file ``wi * m + m + fr +
tpv_offset``, the JAX package's indexing (ROADMAP §3 on what it assumes).
``--mode vis`` shows the windows in the viewer or, headless, writes their
replay and a video (utils/vis_modes.py::view_or_render_windows);
``--stats-vis`` also writes the first window of each take as a composited
video out/wildfc_statsvis_<take>.mp4 (wild_fpv_tpv_video, needs cv2).
"""
from __future__ import annotations

import argparse
import os
import pickle


def compute_wild_forecast_metrics(results, horizons, pose_ctx, meta,
                                  data_dir, m, dt=1.0 / 30.0):
    """{horizon: (pose dist, mean |accel|)}: per window the mean 2D
    distance of its first ``horizon`` forecast frames with valid ground
    truth, averaged over the take's windows with any, then over the takes
    with windows; the smoothness likewise over every window."""
    from ..utils import metrics as mt
    from .eval_pose_wild import keypoint_file
    traj_pred = results["traj_pred"]
    proj = {}
    for take, windows in traj_pred.items():
        flip = meta.get("tpv_flip", {}).get(take, False)
        if windows.shape[0]:
            proj[take] = pose_ctx.project_traj(
                windows.reshape(-1, windows.shape[-1]), flip).reshape(
                windows.shape[:2] + (pose_ctx.nbody, 2))
    out = {}
    for horizon in horizons:
        g_pose, g_smooth, n = 0.0, 0.0, 0
        for take, windows in traj_pred.items():
            tpv_offset = meta.get("tpv_offset", {}).get(take, m)
            t_pose, t_smooth, t_valid = 0.0, 0.0, 0
            for wi in range(windows.shape[0]):
                traj = windows[wi, m:m + horizon]
                pose_dist, valid = 0.0, 0
                for fr in range(traj.shape[0]):
                    gt_file = keypoint_file(data_dir, take,
                                            wi * m + m + fr + tpv_offset)
                    if not os.path.exists(gt_file):
                        continue
                    gt_p = pose_ctx.load_gt_pose(gt_file)
                    if not pose_ctx.check_gt(gt_p):
                        continue
                    valid += 1
                    p2 = pose_ctx.align_qpos(traj[fr], gt_p,
                                             p=proj[take][wi, m + fr])
                    pose_dist += pose_ctx.get_pose_dist(p2, gt_p)
                if valid:
                    t_pose += pose_dist / valid
                    t_valid += 1
                vels = mt.get_joint_vels(traj, dt)
                t_smooth += mt.get_mean_abs(mt.get_joint_accels(vels, dt))
            if windows.shape[0]:
                g_pose += t_pose / max(t_valid, 1)
                g_smooth += t_smooth / windows.shape[0]
                n += 1
        if n:
            g_pose /= n
            g_smooth /= n
        print("all - horizon: %d, pose dist: %.4f, accels: %.4f"
              % (horizon, g_pose, g_smooth))
        out[horizon] = (g_pose, g_smooth)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--egoforecast-cfg", default=None)
    parser.add_argument("--egoforecast-iter", type=int, default=0)
    parser.add_argument("--data", default="wild_01")
    parser.add_argument("--mode", default="stats")
    parser.add_argument("--horizons", type=int, nargs="+", default=[30, 90])
    parser.add_argument("--horizon", type=int, default=None,
                        help="single horizon; overrides --horizons")
    parser.add_argument("--meta-file", default=None)
    parser.add_argument("--take-ind", type=int, default=-1,
                        help="restrict to one take (default all)")
    parser.add_argument("--tpv", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--stats-vis", action="store_true", default=False)
    parser.add_argument("--multi", action="store_true", default=False)
    parser.add_argument("--vis-model", default="humanoid_1205_vis_ghost_v1")
    parser.add_argument("--multi-vis-model",
                        default="humanoid_1205_vis_blank_v1")
    parser.add_argument("--device", default=None,
                        help="torch device of the FK; default cuda (raises "
                             "without CUDA), cpu runs the plain FK")
    args = parser.parse_args(argv)
    if args.horizon is not None:
        args.horizons = [args.horizon]
    if args.mode not in ("stats", "vis"):
        raise SystemExit("unknown --mode %s (stats|vis)" % args.mode)
    from .eval_pose_wild import PrintLogger, load_wild_meta, pose_context

    from .. import resolve_device
    from ..utils.config import EgoForecastConfig

    device = resolve_device(args.device)
    cfg = EgoForecastConfig(args.egoforecast_cfg, create_dirs=False)
    pose_ctx = pose_context(cfg.mujoco_model, device)
    wild_meta = load_wild_meta(args.meta_file)
    res_path = "results/egoforecast/%s/results/iter_%04d_%s.p" % (
        args.egoforecast_cfg, args.egoforecast_iter, args.data)
    with open(res_path, "rb") as f:
        results, _ = pickle.load(f)
    if args.take_ind >= 0:
        keep = list(results["traj_pred"].keys())[args.take_ind]
        results = dict(results)
        results["traj_pred"] = {keep: results["traj_pred"][keep]}
    vis_model = args.multi_vis_model if args.multi else args.vis_model
    if args.mode == "vis":
        from ..utils.vis_modes import view_or_render_windows
        return view_or_render_windows(results, res_path, PrintLogger(),
                                      vis_model=vis_model)
    if args.stats_vis:
        from ..utils.vis_modes import wild_fpv_tpv_video
        os.makedirs("out", exist_ok=True)
        for take, windows in results["traj_pred"].items():
            if windows.shape[0]:
                wild_fpv_tpv_video(
                    windows[0], take, pose_ctx, cfg, wild_meta,
                    "out/wildfc_statsvis_%s.mp4" % take, PrintLogger(),
                    tpv=args.tpv, vis_model=vis_model)
    return compute_wild_forecast_metrics(results, args.horizons, pose_ctx,
                                         wild_meta, cfg.data_dir,
                                         cfg.fr_margin)


if __name__ == "__main__":
    main()
