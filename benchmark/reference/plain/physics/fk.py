"""Batched forward kinematics, plain PyTorch (frozen copy of
egopose_tpu_torch/physics/fk.py::fk)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import quat as Q
from .model import PhysicsModel



class Kin(NamedTuple):
    """World-frame kinematic state of all bodies (batched)."""
    xpos: torch.Tensor    # (B,nb,3) body frame origins
    xquat: torch.Tensor   # (B,nb,4) body frame orientations
    com: torch.Tensor     # (B,nb,3) body coms (world)
    s: torch.Tensor       # (B,nd,6) joint motion subspaces (world)


def fk(m: PhysicsModel, qpos: torch.Tensor) -> Kin:
    """World pose of every body + joint motion subspaces (a loop over tree
    depth, batched within a level).  Within a body, hinges apply
    sequentially about their local axis/anchor (MuJoCo)."""
    nb, nd = m.nbody, m.ndof
    bsz = qpos.shape[0]
    dt = qpos.dtype
    qpos_pad = torch.cat([qpos, qpos.new_zeros(bsz, 1)], 1)
    # one dummy tail row so padded slots write nowhere
    xpos = qpos.new_zeros(bsz, nb + 1, 3)
    xquat = qpos.new_zeros(bsz, nb + 1, 4)
    xquat[..., 0] = 1.0
    s = qpos.new_zeros(bsz, nd + 1, 6)

    root_q = Q.quat_normalize(qpos[:, 3:7])
    r0t = Q.quat_to_mat(root_q).transpose(-1, -2)     # rows = local axes
    xpos[:, 0] = qpos[:, :3]
    xquat[:, 0] = root_q
    s[:, 0:3, 3:] = torch.eye(3, dtype=dt, device=qpos.device)
    s[:, 3:6, :3] = r0t
    s[:, 3:6, 3:] = Q.cross(qpos[:, None, :3].expand(bsz, 3, 3), r0t)

    for body, parent, bodypos, axis, anchor, qidx, didx in m.levels:
        wq = xquat[:, parent]                          # (B,n,4)
        wt = xpos[:, parent] + Q.quat_rotate(wq, bodypos)
        for k in range(3):                             # hinge slots
            a = axis[:, k]
            c = anchor[:, k]
            angle = qpos_pad[:, qidx[:, k]]            # (B,n)
            axis_w = Q.quat_rotate(wq, a)
            anchor_w = wt + Q.quat_rotate(wq, c)
            s[:, didx[:, k]] = torch.cat([axis_w, Q.cross(anchor_w, axis_w)],
                                         -1)
            wq = Q.quat_mul(wq, Q.axis_angle_to_quat(a, angle))
            wt = anchor_w - Q.quat_rotate(wq, c)
        xpos[:, body] = wt
        xquat[:, body] = wq
    xpos, xquat, s = xpos[:, :nb], xquat[:, :nb], s[:, :nd]
    com = xpos + Q.quat_rotate(xquat, m.body_ipos)
    return Kin(xpos=xpos, xquat=xquat, com=com, s=s)


def fk_batched(m: PhysicsModel, qpos: torch.Tensor) -> Kin:
    """The plain fk (the program's K5 computes the same)."""
    return fk(m, qpos)
