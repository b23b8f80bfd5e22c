"""Batched quaternion / rotation ops on torch tensors (wxyz, MuJoCo order).

Counterpart of egopose_tpu/ops/quat.py: every op accepts arbitrary leading
batch dimensions.  Quaternions are (..., 4) tensors laid out as (w, x, y, z).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting 3-vector cross product over the last axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    return quat_conj(q) / torch.clamp(torch.sum(q * q, -1, keepdim=True),
                                      min=_EPS)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (...,3) by quaternion(s) q (...,4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(unit axis (...,3), angle (...)) -> quaternion."""
    half = angle * 0.5
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], -1)


def quat_to_axis_angle(q: torch.Tensor):
    """Unit quaternion -> (unit axis (...,3), angle in [0, 2*pi))."""
    s2 = torch.sum(q[..., 1:] * q[..., 1:], -1)
    s = torch.sqrt(torch.clamp(s2, min=_EPS))
    angle = 2.0 * torch.atan2(s, q[..., 0])
    safe = s2 > 1e-14
    axis = torch.where(safe[..., None], q[..., 1:] / s[..., None],
                       q.new_tensor([1.0, 0.0, 0.0]))
    return axis, torch.where(safe, angle, torch.zeros_like(angle))


def rotvec_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector, angle wrapped to (-pi, pi]."""
    axis, angle = quat_to_axis_angle(q)
    angle = torch.where(angle > math.pi, angle - 2 * math.pi, angle)
    return axis * angle[..., None]


def quat_from_expmap(e: torch.Tensor) -> torch.Tensor:
    angle = torch.linalg.vector_norm(e, dim=-1)
    safe = angle > 1e-12
    axis = torch.where(safe[..., None],
                       e / torch.clamp(angle, min=_EPS)[..., None],
                       e.new_tensor([1.0, 0.0, 0.0]))
    return axis_angle_to_quat(axis, angle)


def quat_from_euler(ex, ey, ez):
    """Euler 'sxyz' (static x-y-z) -> quaternion, R = Rz @ Ry @ Rx."""
    zeros = torch.zeros_like(ex)
    ones = torch.ones_like(ex)
    qx = axis_angle_to_quat(torch.stack([ones, zeros, zeros], -1), ex)
    qy = axis_angle_to_quat(torch.stack([zeros, ones, zeros], -1), ey)
    qz = axis_angle_to_quat(torch.stack([zeros, zeros, ones], -1), ez)
    return quat_mul(qz, quat_mul(qy, qx))


def euler_from_quat_zyx(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> (roll, pitch, yaw), the ZYX decomposition the metrics
    use."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], -1)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """Integrate a unit quaternion by a body-frame angular velocity over dt
    (MuJoCo mj_integratePos for free joints)."""
    return quat_normalize(quat_mul(q, quat_from_expmap(omega_local * dt)))
