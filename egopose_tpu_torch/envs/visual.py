"""Interactive trajectory viewer (counterpart of egopose_tpu/envs/visual.py).

Pure pose puppetry over a visualization model: physics never steps; frames
come from saved qpos trajectories.  The model holds 1, 2 or N humanoid
copies (assets/mujoco_models/humanoid_1205_vis*.xml, each an nq=59 block):
2 copies puppet prediction and ground truth side by side, N copies puppet
time-staggered frames of one trajectory (``--multi``).  It uses MuJoCo's
native viewer where a display exists; the keys are in docs/keymap.md.
The heading and quaternion algebra runs on float64 CPU tensors.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops import math_utils as M
from ..ops import quat as Q

NQ = 59  # humanoid qpos block size


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _np_quat_mul(a, b):
    return Q.quat_mul(_t(a), _t(b)).numpy()


def _np_heading_q(q):
    return M.get_heading_q(_t(q)).numpy()


def _np_quat_rot(q, v):
    return Q.quat_rotate(_t(q), _t(v)).numpy()


def _np_quat_inv(q):
    return Q.quat_inv(_t(q)).numpy()


class TrajectoryViewer:
    """Replays result trajectories with the reference keymap.

    algos: list of (name, results) where results maps take ->
    {"pred": arr, "orig": arr}; arrays are (T, nq) or, for forecast
    results, (n_windows, T, nq) -- q/e steps the window index.
    """

    def __init__(self, model_xml, algos, fps=30, mfr_int=10):
        import mujoco
        self.model = mujoco.MjModel.from_xml_path(model_xml)
        self.data = mujoco.MjData(self.model)
        self.n_copies = self.model.nq // NQ
        self.algos = [(name, res) for name, res in algos if res is not None]
        assert self.algos, "no result sets to view"
        self.algo_ind = 0
        self.takes = list(self.algos[0][1].keys())
        self.fps = fps
        self.fr = 0
        self.take_ind = 0
        self.traj_ind = 0  # prediction instance (forecast windows)
        self.ss_ind = 0
        self.vid_ind = 0
        self.mfr_int = mfr_int
        self.show_gt = False
        self.paused = False
        self.stop = False
        self.reverse = False
        self.speed = 1.0
        self.record = False
        self._renderer = None
        self._vid_frames = []
        self._mujoco = mujoco

    # -- trajectory access ----------------------------------------------------
    def _cur(self, kind):
        res = self.algos[self.algo_ind][1][self.takes[self.take_ind]]
        arr = res.get(kind)
        if arr is None:
            arr = res["pred"]
        if arr.ndim == 3:  # (n_windows, T, nq): q/e picks the window
            arr = arr[self.traj_ind % arr.shape[0]]
        return arr

    def _len(self):
        return self._cur("pred").shape[0]

    def n_windows(self):
        arr = self.algos[self.algo_ind][1][self.takes[self.take_ind]]["pred"]
        return arr.shape[0] if arr.ndim == 3 else 1

    # -- puppeting ------------------------------------------------------------
    def update_pose(self):
        pred = self._cur("pred")
        orig = self._cur("orig")
        fr = min(self.fr, pred.shape[0] - 1, orig.shape[0] - 1)
        q = self.data.qpos
        if self.n_copies >= 3:
            # multi mode: copy i shows frame fr + i*mfr_int, heading-aligned
            # to the GT at fr and fanned out sideways
            traj = orig if self.show_gt else pred
            hq = _np_heading_q(orig[fr, 3:7])
            rel_q = _np_quat_mul(hq, _np_quat_inv(_np_heading_q(
                traj[fr, 3:7])))
            vec = _np_quat_rot(hq, np.array([0.0, -1.0, 0.0]))[:2]
            for i in range(self.n_copies):
                fr_m = min(fr + i * self.mfr_int, traj.shape[0] - 1)
                q[i * NQ:(i + 1) * NQ] = traj[fr_m]
                q[i * NQ + 3:i * NQ + 7] = _np_quat_mul(rel_q,
                                                        traj[fr_m, 3:7])
                q[i * NQ:i * NQ + 2] = orig[fr, :2] + vec * 0.8 * i
        elif self.n_copies == 2:
            q[:NQ] = pred[fr]
            q[NQ:2 * NQ] = orig[fr]
            q[NQ] += 1.0  # x-offset the reference copy
        else:
            q[:NQ] = (orig if self.show_gt else pred)[fr]
        self._mujoco.mj_forward(self.model, self.data)

    # -- key contract (docs/keymap.md) ----------------------------------------
    def key_callback(self, keycode):
        import glfw  # mujoco's viewer passes glfw keycodes
        k = keycode
        if k == glfw.KEY_SPACE:
            self.paused = not self.paused
        elif k == glfw.KEY_LEFT and self.paused:
            self.fr = max(0, self.fr - 1)
        elif k == glfw.KEY_RIGHT and self.paused:
            self.fr = min(self._len() - 1, self.fr + 1)
        elif k == glfw.KEY_W:
            self.fr = 0
        elif k == glfw.KEY_S:
            self.reverse = not self.reverse
        elif k == glfw.KEY_D:
            self.speed = max(self.speed / 1.5, 0.1)
        elif k == glfw.KEY_F:
            self.speed = min(self.speed * 1.5, 8.0)
        elif k == glfw.KEY_R:
            self.stop = True
        elif k == glfw.KEY_Z:
            self.take_ind = (self.take_ind - 1) % len(self.takes)
            self.fr = self.traj_ind = 0
        elif k == glfw.KEY_C:
            self.take_ind = (self.take_ind + 1) % len(self.takes)
            self.fr = self.traj_ind = 0
        elif k == glfw.KEY_Q:
            self.traj_ind = (self.traj_ind - 1) % self.n_windows()
            self.fr = 0
        elif k == glfw.KEY_E:
            self.traj_ind = (self.traj_ind + 1) % self.n_windows()
            self.fr = 0
        elif k == glfw.KEY_X:
            self._screenshot()
        elif k == glfw.KEY_V:
            self._toggle_video()
        elif glfw.KEY_1 <= k < glfw.KEY_1 + len(self.algos):
            self.algo_ind = k - glfw.KEY_1
            self.fr = min(self.fr, self._len() - 1)
        elif k == glfw.KEY_0:
            self.show_gt = not self.show_gt
        elif k == glfw.KEY_MINUS:
            self.mfr_int = max(1, self.mfr_int - 1)
        elif k == glfw.KEY_EQUAL:
            self.mfr_int += 1
        else:
            return
        self.update_pose()

    def _offscreen(self):
        """The viewer's offscreen renderer, made at first use; raises
        RuntimeError where no GL context can be made."""
        from ..utils.render import make_offscreen_renderer
        if self._renderer is None:
            self._renderer = make_offscreen_renderer(self.model)
        return self._renderer

    def _toggle_video(self):
        """'v': start or stop recording the displayed frames to
        out/video_NNNN.mp4."""
        if self.record:
            self.record = False
            self._save_video()
            return
        try:
            self._offscreen()
        except RuntimeError:
            return  # no offscreen GL on this host
        self._vid_frames = []
        self.record = True

    def _save_video(self):
        frames, self._vid_frames = self._vid_frames, []
        if not frames:
            return
        os.makedirs("out", exist_ok=True)
        path = "out/video_%04d" % self.vid_ind
        self.vid_ind += 1
        try:
            import cv2
            h, w = frames[0].shape[:2]
            vw = cv2.VideoWriter(path + ".mp4",
                                 cv2.VideoWriter_fourcc(*"mp4v"),
                                 self.fps, (w, h))
            for f in frames:
                vw.write(f[..., ::-1])
            vw.release()
        except ImportError:
            np.save(path + ".npy", np.stack(frames))

    def _screenshot(self):
        """'x': the current frame to out/NNNN.png (.npy without cv2)."""
        try:
            renderer = self._offscreen()
        except RuntimeError:
            return  # no offscreen GL on this host
        os.makedirs("out", exist_ok=True)
        renderer.update_scene(self.data)
        img = renderer.render()
        try:
            import cv2
            cv2.imwrite("out/%04d.png" % self.ss_ind, img[..., ::-1])
        except ImportError:
            np.save("out/%04d.npy" % self.ss_ind, img)
        self.ss_ind += 1

    def run(self):
        # ``mujoco.viewer`` is a submodule that ``import mujoco`` does not
        # load; without this import the interactive path fails even on a
        # host with a display
        import mujoco.viewer

        # pre-flight the display: on a headless host launch_passive exits
        # the process ("could not initialize GLFW") instead of raising,
        # which would kill the caller's headless fallback; GLFW's own init
        # fails with a return code that can be caught
        import glfw
        if not glfw.init():
            raise RuntimeError("no display: GLFW init failed")
        glfw.terminate()  # launch_passive initializes it again

        mujoco = self._mujoco
        self.update_pose()
        with mujoco.viewer.launch_passive(
                self.model, self.data,
                key_callback=self.key_callback) as viewer:
            while viewer.is_running() and not self.stop:
                self.update_pose()
                viewer.sync()
                if self.record:
                    self._renderer.update_scene(self.data)
                    self._vid_frames.append(self._renderer.render())
                if not self.paused:
                    step = -1 if self.reverse else 1
                    self.fr = int(np.clip(self.fr + step, 0, self._len() - 1))
                time.sleep(1.0 / (self.fps * self.speed))
