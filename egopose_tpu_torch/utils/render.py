"""Host-side trajectory rendering (counterpart of
egopose_tpu/utils/render.py).

Replays saved qpos trajectories through MuJoCo's offscreen renderer and
writes a video.  The physics never runs here: rendering is pose puppetry.
Where no GL renderer or video encoder exists (no ``mujoco``, no ``cv2``, or
no GL context), the trajectories or frames go to an ``.npz`` instead, so a
vis mode always leaves its output.  This fallback is host code; the
rollouts that produce the trajectories run on the device as always.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

_OFFSCREEN_BROKEN = None  # first construction failure, cached per process

# Constructs one renderer in a child process; its exit code says whether
# this host can make a GL context.
_PROBE = ("import mujoco\n"
          "mujoco.Renderer(mujoco.MjModel.from_xml_string('<mujoco/>'), 8, 8)")


def _probe_offscreen():
    """None where a child process can construct ``mujoco.Renderer``, else
    the reason it could not."""
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE],
                             capture_output=True, text=True, timeout=120)
    except subprocess.TimeoutExpired:
        return "renderer probe timed out"
    if out.returncode == 0:
        return None
    lines = out.stderr.strip().splitlines()
    return lines[-1] if lines else "renderer probe exited %d" \
        % out.returncode


def make_offscreen_renderer(model, height=480, width=640):
    """``mujoco.Renderer`` with its failure cached for the whole process.

    On a GL-less host the first failed construction raises a catchable
    error but leaves the GL loader in a state where a second one aborts
    the interpreter.  Another package in the process (the JAX one, in the
    parity tests) may make its own first attempt, so this module never
    fails in-process: a child process tries first, and after a failure
    there every caller gets a plain RuntimeError without touching the GL
    stack."""
    global _OFFSCREEN_BROKEN
    if _OFFSCREEN_BROKEN is None:
        _OFFSCREEN_BROKEN = _probe_offscreen() or False
    if _OFFSCREEN_BROKEN:
        raise RuntimeError(
            "offscreen renderer unavailable: %s" % _OFFSCREEN_BROKEN)
    import mujoco
    try:
        return mujoco.Renderer(model, height=height, width=width)
    except Exception as e:
        _OFFSCREEN_BROKEN = repr(e)
        raise RuntimeError(
            "offscreen renderer unavailable: %s" % _OFFSCREEN_BROKEN) from e


def render_qpos_video(trajs, out_path, fps=30, res=(640, 480),
                      model_xml=None, spacing=1.0):
    """Render one or more (T, nq) qpos trajectories side by side to a
    video at ``out_path``; returns the path written.  Without a renderer
    or encoder it writes the trajectories to ``<out_path minus ext>.npz``
    (``traj_0``, ``traj_1``, ...) and returns that path."""
    try:
        import mujoco
        from ..physics.spec import export_mjcf, parse_mjcf
        from .assets import find_model_xml
        spec = parse_mjcf(find_model_xml(model_xml or "humanoid_1205_v1"))
        model = mujoco.MjModel.from_xml_string(export_mjcf(spec))
        data = mujoco.MjData(model)
        renderer = make_offscreen_renderer(model, height=res[1],
                                           width=res[0])
        frames = []
        t_len = min(t.shape[0] for t in trajs)
        for t in range(t_len):
            row = []
            for k, traj in enumerate(trajs):
                q = np.array(traj[t])
                q[1] += spacing * k  # offset each trajectory sideways
                data.qpos[:] = q
                mujoco.mj_forward(model, data)
                renderer.update_scene(data)
                row.append(renderer.render())
            frames.append(np.concatenate(row, axis=1))
        _write_video(frames, out_path, fps)
        return out_path
    except Exception:  # headless fallback
        alt = os.path.splitext(out_path)[0] + ".npz"
        np.savez_compressed(alt, **{f"traj_{i}": np.asarray(t)
                                    for i, t in enumerate(trajs)})
        return alt


def save_replay(out_path, traj_pred: dict, traj_orig: dict):
    """Prediction and reference trajectories per take in one ``.npz``
    (``pred__<take>``, ``orig__<take>``) that the TrajectoryViewer
    (envs/visual.py) can replay: the headless form of ``--render``."""
    payload = {}
    for take in traj_pred:
        payload[f"pred__{take}"] = np.asarray(traj_pred[take])
        if take in traj_orig:
            payload[f"orig__{take}"] = np.asarray(traj_orig[take])
    np.savez_compressed(out_path, **payload)
    return out_path


def _write_video(frames, out_path, fps, bgr=False):
    """Encode ``frames`` to ``out_path``; they are RGB (the renderer's
    output) unless ``bgr`` (cv2-native frames), so channels are not swapped
    twice on the way into the BGR VideoWriter.  Without an encoder the
    frames go to ``<out_path minus ext>.npz`` as ``frames``."""
    try:
        import cv2
        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
        for f in frames:
            vw.write(f if bgr else f[..., ::-1])
        vw.release()
    except Exception:
        np.savez_compressed(os.path.splitext(out_path)[0] + ".npz",
                            frames=np.stack(frames))
