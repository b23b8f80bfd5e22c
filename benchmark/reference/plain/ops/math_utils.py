"""Batched kinematic math used by the env, rewards and metrics
(counterpart of egopose_tpu/ops/math_utils.py).  Quaternions are wxyz."""
from __future__ import annotations

import torch

from .quat import (quat_inv, quat_mul, quat_normalize, quat_rotate_inv,
                   rotvec_from_quat)


def get_heading_q(q: torch.Tensor) -> torch.Tensor:
    """Yaw-only quaternion: zero x, y and renormalize."""
    return quat_normalize(q * q.new_tensor([1.0, 0.0, 0.0, 1.0]))


def get_heading(q: torch.Tensor) -> torch.Tensor:
    """Heading angle (rad) with the sign canonicalized on z."""
    hq = q * q.new_tensor([1.0, 0.0, 0.0, 1.0])
    hq = torch.where(hq[..., 3:4] < 0, -hq, hq)
    hq = quat_normalize(hq)
    return 2.0 * torch.acos(torch.clamp(hq[..., 0], -1.0, 1.0))


def de_heading(q: torch.Tensor) -> torch.Tensor:
    """heading(q)^-1 * q."""
    return quat_mul(quat_inv(get_heading_q(q)), q)


def transform_vec(v: torch.Tensor, q: torch.Tensor,
                  coord: str = "root") -> torch.Tensor:
    """World vector v in the root ('root') or heading ('heading') frame."""
    if coord == "root":
        return quat_rotate_inv(q, v)
    if coord == "heading":
        return quat_rotate_inv(get_heading_q(q), v)
    raise ValueError(f"unknown coord {coord}")


def get_qvel_fd(cur_qpos: torch.Tensor, next_qpos: torch.Tensor, dt,
                transform: str | None = None) -> torch.Tensor:
    """Finite-difference generalized velocity between qpos frames:
    [linear (world or `transform` frame), angular (root frame), joints]."""
    v = (next_qpos[..., :3] - cur_qpos[..., :3]) / dt
    qrel = quat_mul(next_qpos[..., 3:7], quat_inv(cur_qpos[..., 3:7]))
    rv = rotvec_from_quat(qrel) / dt
    rv = quat_rotate_inv(cur_qpos[..., 3:7], rv)
    jvel = (next_qpos[..., 7:] - cur_qpos[..., 7:]) / dt
    if transform is not None:
        v = transform_vec(v, cur_qpos[..., 3:7], transform)
    return torch.cat([v, rv, jvel], -1)


def multi_quat_diff(nq1: torch.Tensor, nq0: torch.Tensor) -> torch.Tensor:
    """Relative quaternions q1 * q0^-1 for N stacked joints (flat (...,4N))."""
    shape = nq1.shape[:-1] + (nq1.shape[-1] // 4, 4)
    d = quat_mul(nq1.reshape(shape), quat_inv(nq0.reshape(shape)))
    return d.reshape(nq1.shape)


def multi_quat_norm(nq: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude per joint = arccos of the clipped scalar part."""
    return torch.acos(torch.clamp(nq[..., ::4], -1.0, 1.0))


def get_angvel_fd(prev_bquat: torch.Tensor, cur_bquat: torch.Tensor,
                  dt) -> torch.Tensor:
    """Per-joint finite-difference angular velocity (flat (...,4N) ->
    (...,3N))."""
    qd = multi_quat_diff(cur_bquat, prev_bquat)
    n = qd.shape[-1] // 4
    rv = rotvec_from_quat(qd.reshape(qd.shape[:-1] + (n, 4))) / dt
    return rv.reshape(qd.shape[:-1] + (3 * n,))
