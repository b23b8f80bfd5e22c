"""Pose-estimation metrics over frames (counterpart of
egopose_tpu/utils/metrics.py).  numpy in, numpy out; the rotation math runs
in float64 on the CPU through the port's quaternion ops."""
from __future__ import annotations

import numpy as np
import torch

from ..ops import math_utils as M
from ..ops import quat as Q


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def get_joint_angles(poses: np.ndarray) -> np.ndarray:
    """Root euler (yaw zeroed) + joint angles."""
    e = Q.euler_from_quat_zyx(_t(poses[:, 3:7])).numpy()
    e[:, 2] = 0.0
    return np.hstack([e, poses[:, 7:]])


def get_joint_vels(poses: np.ndarray, dt: float) -> np.ndarray:
    """Finite-difference generalized velocities in the heading frame."""
    return M.get_qvel_fd(_t(poses[:-1]), _t(poses[1:]), dt,
                         "heading").numpy()


def get_joint_accels(vels: np.ndarray, dt: float) -> np.ndarray:
    return np.diff(vels, axis=0) / dt


def get_mean_dist(x: np.ndarray, y: np.ndarray) -> float:
    return float(np.linalg.norm(x - y, axis=1).mean())


def get_mean_abs(x: np.ndarray) -> float:
    return float(np.abs(x).mean())
