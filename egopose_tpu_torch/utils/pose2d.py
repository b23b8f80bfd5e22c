"""2D keypoint projection and alignment for the in-the-wild metrics
(counterpart of egopose_tpu/utils/pose2d.py).

The 3D body positions come from the port's forward kinematics: one
``physics/fk.py::fk_batched`` call over every frame of a trajectory (the
CUDA kernel K5 on a CUDA model, the plain ``fk`` on a CPU one); the camera
algebra then runs per frame on the host in float64, as the JAX package's
per-frame ``project_qpos`` does.  Drawing (``draw_pose``) is not ported.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..physics.fk import fk_batched
from ..physics.model import PhysicsModel
from ..physics.spec import ModelSpec

BODY_SET = {"LeftForeArm", "RightForeArm", "LeftHand", "RightHand",
            "LeftArm", "RightArm", "LeftUpLeg", "RightUpLeg", "LeftLeg",
            "RightLeg", "LeftFoot", "RightFoot"}

# OpenPose keypoint index -> body name
JOINTS_MAP = [(2, "RightArm"), (3, "RightForeArm"), (4, "RightHand"),
              (5, "LeftArm"), (6, "LeftForeArm"), (7, "LeftHand"),
              (9, "RightUpLeg"), (10, "RightLeg"), (11, "RightFoot"),
              (12, "LeftUpLeg"), (13, "LeftLeg"), (14, "LeftFoot")]

CONN = [("RightUpLeg", "RightArm", (255, 255, 0)),
        ("RightArm", "RightForeArm", (255, 191, 0)),
        ("RightForeArm", "RightHand", (255, 191, 0)),
        ("RightUpLeg", "RightLeg", (255, 64, 0.0)),
        ("RightLeg", "RightFoot", (255, 64, 0.0)),
        ("LeftUpLeg", "LeftArm", (0, 255, 128)),
        ("LeftArm", "LeftForeArm", (0, 255, 255)),
        ("LeftForeArm", "LeftHand", (0, 255, 255)),
        ("LeftUpLeg", "LeftLeg", (0, 64, 255)),
        ("LeftLeg", "LeftFoot", (0, 64, 255))]


class Pose2DContext:
    def __init__(self, model: PhysicsModel, spec: ModelSpec):
        self.model = model
        self.spec = spec
        names = spec.body_names
        self.body_filter = np.array([n in BODY_SET for n in names])
        self.body_names = [n for n in names if n in BODY_SET]
        self.body2id = {n: i for i, n in enumerate(self.body_names)}
        self.nbody = len(self.body_names)
        self.conn = CONN
        self.joints_map = [(i1, self.body2id[n]) for i1, n in JOINTS_MAP]

    # -- ground truth keypoints ----------------------------------------------
    def load_gt_pose(self, filename):
        with open(filename) as f:
            keypoints = json.load(f)["people"][0]["pose_keypoints_2d"]
        p = np.zeros((self.nbody, 3))
        for i1, i2 in self.joints_map:
            p[i2, :] = keypoints[3 * i1:3 * i1 + 3]
        return p

    def check_gt(self, gt_pose):
        return gt_pose[self.body2id["LeftUpLeg"], 2] > 0.1 or \
            gt_pose[self.body2id["RightUpLeg"], 2] > 0.1

    # -- metric ---------------------------------------------------------------
    def dist_scale(self, gt_p):
        """The metric's scale: 0.5 over the ground truth's shoulder-to-hip
        height in the image (the left side where both are seen)."""
        b = self.body2id
        if gt_p[b["LeftArm"], 2] > 0.1 and gt_p[b["LeftUpLeg"], 2] > 0.1:
            kp1, kp2 = "LeftArm", "LeftUpLeg"
        else:
            kp1, kp2 = "RightArm", "RightUpLeg"
        return 0.5 / abs(gt_p[b[kp1], 1] - gt_p[b[kp2], 1])

    def get_pose_dist(self, p, gt_p):
        scale = self.dist_scale(gt_p)
        dist, num = 0.0, 0
        for i in range(gt_p.shape[0]):
            if gt_p[i, 2] > 0.1:
                dist += np.linalg.norm(gt_p[i, :2] - p[i, :]) * scale
                num += 1
        return dist / num

    # -- projection -----------------------------------------------------------
    def project_traj(self, qpos, flip=False):
        """(T, nbody, 2) image coordinates of every frame of ``qpos`` (T,
        nq): one batched FK in the model's dtype on its device (K5 on the
        card), then a camera 10 m in front of the hips, looking at them
        level, per frame in float64."""
        qpos = torch.as_tensor(np.asarray(qpos)).to(
            device=self.model.device, dtype=self.model.dtype)
        if qpos.shape[0] == 0:
            return np.zeros((0, self.nbody, 2))
        xpos = fk_batched(self.model, qpos.contiguous()).xpos
        pose_3d = xpos.cpu().double().numpy()[:, self.body_filter]
        b = self.body2id
        vp = (pose_3d[:, b["LeftUpLeg"]] + pose_3d[:, b["RightUpLeg"]]) * 0.5
        v = pose_3d[:, b["RightUpLeg"]] - pose_3d[:, b["LeftUpLeg"]]
        if flip:
            v = -v
        v[:, 2] = 0
        x = v / np.linalg.norm(v, axis=1, keepdims=True)
        z = np.broadcast_to(np.array([0.0, 0.0, 1.0]), x.shape)
        y = np.cross(z, x)
        r = np.stack((-y, z, x), axis=2)                  # columns -y, z, x
        rt = r.transpose(0, 2, 1)
        t = (vp - 10 * x)[:, :, None]
        e = np.concatenate((rt, -np.matmul(rt, t)), axis=2)     # (T, 3, 4)
        ones = np.ones(pose_3d.shape[:2] + (1,))
        p = np.matmul(np.concatenate((pose_3d, ones), axis=2),
                      e.transpose(0, 2, 1))
        p = p[..., :2] / p[..., [2]]
        p[..., 1] *= -1
        return p

    def project_qpos(self, qpos, flip=False):
        """(nbody, 2) image coordinates of one qpos row."""
        return self.project_traj(np.asarray(qpos)[None], flip)[0]

    # -- alignment ------------------------------------------------------------
    def align_qpos(self, qpos, gt_p, scale=None, flip=False, p=None):
        """The projection of ``qpos`` (or the already projected ``p``)
        scaled to the ground truth's leg length and moved onto its hips."""
        b = self.body2id
        if p is None:
            p = self.project_qpos(qpos, flip)
        base = np.zeros((1, 2))
        n = 0
        if gt_p[b["LeftUpLeg"], 2] > 0.1:
            base += gt_p[[b["LeftUpLeg"]], :2]
            n += 1
        if gt_p[b["RightUpLeg"], 2] > 0.1:
            base += gt_p[[b["RightUpLeg"]], :2]
            n += 1
        base /= n
        if scale is None:
            if gt_p[b["LeftLeg"], 2] > 0.1 and gt_p[b["LeftUpLeg"], 2] > 0.1:
                kp1, kp2 = "LeftLeg", "LeftUpLeg"
            else:
                kp1, kp2 = "RightLeg", "RightUpLeg"
            scale = np.linalg.norm(gt_p[b[kp1]] - gt_p[b[kp2]]) \
                / np.linalg.norm(p[b[kp1]] - p[b[kp2]])
        return p * scale + base
