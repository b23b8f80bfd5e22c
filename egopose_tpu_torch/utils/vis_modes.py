"""Vis modes of the eval CLIs, with a headless form (counterpart of
egopose_tpu/utils/vis_modes.py).

With a display the TrajectoryViewer (envs/visual.py) is the interactive
path; on a display-less host the same information is written as
composited videos or replay files, and where no renderer or encoder
exists either, as ``.npz`` arrays (utils/render.py).
"""
from __future__ import annotations

import glob
import os

import numpy as np


def view_or_render_windows(results, res_path, logger, vis_model=None):
    """Forecast-window vis: the interactive TrajectoryViewer (q/e steps the
    window, z/c the take) or, headless, a replay npz of every window and a
    video of the first take's first window.  Returns the video's path
    (its npz fallback's without an encoder), None with a display or no
    windows."""
    orig = results.get("traj_orig") or {}
    windows = {take: {"pred": results["traj_pred"][take],
                      "orig": orig.get(take, results["traj_pred"][take])}
               for take in results["traj_pred"]
               if results["traj_pred"][take].shape[0] > 0}
    if not windows:
        logger.info("no windows to visualize")
        return None
    from .assets import find_model_xml
    xml = find_model_xml(vis_model or "humanoid_1205_vis_double_v1")
    try:
        from ..envs.visual import TrajectoryViewer
        TrajectoryViewer(xml, [("forecast", windows)]).run()
        return None
    except Exception as e:
        logger.info("no display (%s) -- writing replay + video" % e)
    from .render import render_qpos_video, save_replay
    base = os.path.splitext(res_path)[0]
    save_replay(base + "_replay.npz",
                {t: r["pred"] for t, r in windows.items()},
                {t: r["orig"] for t, r in windows.items()})
    first = windows[sorted(windows)[0]]
    written = render_qpos_video([first["pred"][0], first["orig"][0]],
                                base + ".mp4")
    logger.info("wrote %s and %s_replay.npz" % (written, base))
    return written


def _load_frames(folder, exts=("png", "jpg")):
    """The images of ``folder`` in name order, read by cv2 (BGR); [] where
    there are none or cv2 is missing."""
    files = sorted(f for e in exts
                   for f in glob.glob(os.path.join(folder, f"*.{e}")))
    try:
        import cv2
    except ImportError:
        return []
    return [cv2.imread(f) for f in files]


def wild_fpv_tpv_video(traj_pred, take, pose_ctx, cfg, wild_meta, out_path,
                       logger, tpv=True, fps=30, vis_model=None):
    """Headless form of the reference's wild FPV/TPV synced viewer: per
    frame, a composite of

      [3D render of the predicted pose | FPV frame | TPV frame with the
      projected keypoint skeleton drawn over it]

    A missing image folder drops its panel; without a renderer the
    projected keypoints are still drawn on a blank canvas, so the output
    always exists.  The take is projected once (``project_traj``: one K5
    launch on a CUDA model), then drawn frame by frame.  Needs cv2.
    Returns the path written (the video, or its ``.npz`` fallback)."""
    import cv2

    traj_ub = wild_meta.get("traj_ub", {}).get(take, traj_pred.shape[0])
    traj_pred = traj_pred[:traj_ub]
    tpv_offset = wild_meta.get("tpv_offset", {}).get(take, cfg.fr_margin)
    flip = wild_meta.get("tpv_flip", {}).get(take, False)

    fpv = _load_frames("datasets/fpv_frames/%s" % take)
    if fpv and cfg.fr_margin:
        fpv = fpv[cfg.fr_margin:-cfg.fr_margin]
    tpv_frames = _load_frames("datasets/tpv/s_frames/%s" % take) if tpv \
        else []

    # 3D pose panel through the offscreen renderer, where there is one
    renderer = model = data = None
    try:
        import mujoco
        from ..physics.spec import export_mjcf, parse_mjcf
        from .assets import find_model_xml
        from .render import make_offscreen_renderer
        spec = parse_mjcf(find_model_xml(vis_model or cfg.mujoco_model))
        model = mujoco.MjModel.from_xml_string(export_mjcf(spec))
        data = mujoco.MjData(model)
        renderer = make_offscreen_renderer(model, height=360, width=360)
    except Exception as e:
        logger.info("no offscreen GL (%s) -- keypoint panels only" % e)

    proj = pose_ctx.project_traj(traj_pred, flip)
    frames = []
    h = 360
    for fr in range(traj_pred.shape[0]):
        panels = []
        if renderer is not None:
            # multi-humanoid vis models carry N copies; puppet the first
            nq = min(model.nq, traj_pred.shape[1])
            data.qpos[:nq] = traj_pred[fr][:nq]
            mujoco.mj_forward(model, data)
            renderer.update_scene(data)
            panels.append(renderer.render()[..., ::-1].copy())
        if fpv and fr < len(fpv) and fpv[fr] is not None:
            f = fpv[fr]
            panels.append(cv2.resize(f, (int(f.shape[1] * h / f.shape[0]),
                                         h)))
        tfr = fr + tpv_offset
        if tpv_frames and 0 <= tfr < len(tpv_frames) \
                and tpv_frames[tfr] is not None:
            img = tpv_frames[tfr].copy()
        else:
            img = np.full((h, h, 3), 32, np.uint8)
        p2 = proj[fr]
        scale = h / max(p2[:, 1].max() - p2[:, 1].min(), 1e-6) * 0.5
        p2 = (p2 - p2.mean(0)) * scale + np.array([img.shape[1] / 2,
                                                   img.shape[0] / 2])
        pose_ctx.draw_pose(img, p2)
        panels.append(cv2.resize(img, (int(img.shape[1] * h / img.shape[0]),
                                       h)))
        frames.append(np.concatenate(panels, axis=1))

    from .render import _write_video
    _write_video(frames, out_path, fps, bgr=True)  # panels are cv2-native
    written = out_path if os.path.exists(out_path) else \
        os.path.splitext(out_path)[0] + ".npz"
    logger.info("wrote wild vis for %s to %s" % (take, written))
    return written
