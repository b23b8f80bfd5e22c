"""Wild pose-estimation metrics (counterpart of
egopose_tpu/cli/eval_pose_wild.py, ``--mode stats``): the scale-normalised
2D keypoint distance against OpenPose ground truth and the smoothness.

    python -m egopose_tpu_torch.cli.eval_pose_wild --egomimic-cfg subject_03 \\
        --egomimic-iter 3000 [--statereg-cfg C --statereg-iter N] \\
        --data wild_01 [--meta-file M] [--device cuda|cpu]

Each take is projected once (one batched FK: K5 on the card) and scored
per frame against datasets/tpv/poses/<take>/%05d_keypoints.json.
"""
from __future__ import annotations

import argparse
import os
import pickle


def vis_refusals(args, vis_model_default):
    """NotImplementedError for a vis option set on ``args``."""
    for flag, on in (("--mode vis", args.mode == "vis"),
                     ("--stats-vis", args.stats_vis),
                     ("--multi", args.multi),
                     ("--vis-model", args.vis_model != vis_model_default)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP §1 item 2)")
    if args.mode != "stats":
        raise SystemExit("unknown --mode %s (stats|vis)" % args.mode)


def load_wild_meta(meta_file):
    """The per-take tpv_offset / tpv_flip / traj_ub of a meta yaml ({}
    without one)."""
    import yaml
    if meta_file and os.path.exists(meta_file):
        with open(meta_file) as f:
            return yaml.safe_load(f)
    return {}


def keypoint_file(data_dir, take, fr):
    return "%s/tpv/poses/%s/%05d_keypoints.json" % (data_dir, take, fr)


def compute_wild_metrics(res, algo, takes, pose_ctx, meta, data_dir,
                         fr_margin, dt=1.0 / 30.0, verbose=True):
    """(pose dist, mean |accel|) averaged over ``takes``: the 2D distance
    of each frame with valid ground truth at frame ``fr + tpv_offset``
    after alignment, averaged over a take's frames."""
    from ..utils import metrics as mt
    if res is None:
        return None
    if verbose:
        print("=" * 10 + " %s " % algo + "=" * 10)
    g_pose, g_smooth = 0.0, 0.0
    for take in takes:
        traj_pred = res["traj_pred"][take]
        traj_ub = meta.get("traj_ub", {}).get(take, traj_pred.shape[0])
        traj_pred = traj_pred[:traj_ub]
        tpv_offset = meta.get("tpv_offset", {}).get(take, fr_margin)
        flip = meta.get("tpv_flip", {}).get(take, False)
        proj = pose_ctx.project_traj(traj_pred, flip)
        pose_dist, valid = 0.0, 0
        for fr in range(max(0, -tpv_offset), traj_pred.shape[0]):
            gt_file = keypoint_file(data_dir, take, fr + tpv_offset)
            if not os.path.exists(gt_file):
                continue
            gt_p = pose_ctx.load_gt_pose(gt_file)
            if not pose_ctx.check_gt(gt_p):
                continue
            valid += 1
            p2 = pose_ctx.align_qpos(traj_pred[fr], gt_p, flip=flip,
                                     p=proj[fr])
            pose_dist += pose_ctx.get_pose_dist(p2, gt_p)
        pose_dist /= max(valid, 1)
        vels = mt.get_joint_vels(traj_pred, dt)
        accels = mt.get_joint_accels(vels, dt)
        smooth = mt.get_mean_abs(accels)
        if verbose:
            print("%s - pose dist: %.4f, accels: %.4f" % (take, pose_dist,
                                                          smooth))
        g_pose += pose_dist
        g_smooth += smooth
    g_pose /= len(takes)
    g_smooth /= len(takes)
    if verbose:
        print("-" * 60)
        print("all - pose dist: %.4f, accels: %.4f" % (g_pose, g_smooth))
        print("-" * 60 + "\n")
    return g_pose, g_smooth


def pose_context(mujoco_model, device, dtype=None):
    """A Pose2DContext on a model of ``mujoco_model`` on ``device``, in
    float32 unless ``dtype`` says otherwise (the JAX package's metric CLIs
    build it in float32)."""
    import torch
    from ..physics.model import build_model
    from ..physics.spec import parse_mjcf
    from ..utils.assets import find_model_xml
    from ..utils.pose2d import Pose2DContext
    spec = parse_mjcf(find_model_xml(mujoco_model))
    return Pose2DContext(build_model(spec, dtype=dtype or torch.float32,
                                     device=device), spec)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--egomimic-cfg", default=None)
    parser.add_argument("--statereg-cfg", default=None)
    parser.add_argument("--egomimic-iter", type=int, default=0)
    parser.add_argument("--statereg-iter", type=int, default=0)
    parser.add_argument("--data", default="wild_01")
    parser.add_argument("--mode", default="stats")
    parser.add_argument("--meta-file", default=None,
                        help="yaml with tpv_offset/tpv_flip/traj_ub")
    parser.add_argument("--take-ind", type=int, default=-1,
                        help="restrict to one take (default all)")
    parser.add_argument("--tpv", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--stats-vis", action="store_true", default=False)
    parser.add_argument("--multi", action="store_true", default=False)
    parser.add_argument("--vis-model", default="humanoid_1205_vis_single_v1")
    parser.add_argument("--multi-vis-model",
                        default="humanoid_1205_vis_estimate_v1")
    parser.add_argument("--device", default=None,
                        help="torch device of the FK; default cuda (raises "
                             "without CUDA), cpu runs the plain FK")
    args = parser.parse_args(argv)
    vis_refusals(args, "humanoid_1205_vis_single_v1")

    from .. import resolve_device
    from ..utils.config import EgoMimicConfig

    device = resolve_device(args.device)
    cfg = EgoMimicConfig(args.egomimic_cfg, create_dirs=False)
    pose_ctx = pose_context(cfg.mujoco_model, device)
    wild_meta = load_wild_meta(args.meta_file)

    em_res = sr_res = None
    if args.egomimic_cfg is not None:
        path = "results/egomimic/%s/results/iter_%04d_%s.p" % (
            args.egomimic_cfg, args.egomimic_iter, args.data)
        with open(path, "rb") as f:
            em_res, _ = pickle.load(f)
    if args.statereg_cfg is not None:
        path = "results/statereg/%s/results/iter_%04d_%s.p" % (
            args.statereg_cfg, args.statereg_iter, args.data)
        with open(path, "rb") as f:
            sr_res, _ = pickle.load(f)

    takes = list((em_res or sr_res)["traj_pred"].keys())
    if args.take_ind >= 0:
        takes = [takes[args.take_ind]]
    return {"ego_mimic": compute_wild_metrics(
                em_res, "ego mimic", takes, pose_ctx, wild_meta,
                cfg.data_dir, cfg.fr_margin),
            "state_reg": compute_wild_metrics(
                sr_res, "state reg", takes, pose_ctx, wild_meta,
                cfg.data_dir, cfg.fr_margin)}


if __name__ == "__main__":
    main()
