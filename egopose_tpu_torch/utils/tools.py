"""Result-dict and trajectory helpers (counterpart of
egopose_tpu/utils/tools.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops import math_utils as M
from ..ops import quat as Q


def sync_traj(qpos_traj, qvel_traj, ref_qpos):
    """Re-anchor a trajectory's heading and xy to a reference qpos: the
    first frame takes the reference's heading and xy, every frame moves
    with it, and the root velocities turn by the same heading.  numpy in
    (T, nq), (T, nv), (nq,); numpy out, in the trajectory's dtype."""
    qp = torch.as_tensor(np.asarray(qpos_traj))
    qv = torch.as_tensor(np.asarray(qvel_traj)).to(qp.dtype)
    ref = torch.as_tensor(np.asarray(ref_qpos)).to(qp.dtype)
    rel_heading = Q.quat_mul(M.get_heading_q(ref[3:7]),
                             Q.quat_inv(M.get_heading_q(qp[0, 3:7])))
    start_pos = torch.cat([qp[0, :2], ref[2:3]])
    rh = rel_heading.expand(qp.shape[0], 4)
    new_qp, new_qv = qp.clone(), qv.clone()
    new_qp[:, :2] = Q.quat_rotate(rh, qp[:, :3] - start_pos)[:, :2] \
        + ref[:2]
    new_qp[:, 3:7] = Q.quat_mul(rh, qp[:, 3:7])
    new_qv[:, :3] = Q.quat_rotate(rh, qv[:, :3])
    return new_qp.numpy(), new_qv.numpy()


def remove_noisy_hands(results):
    """Zero the hand dims of every trajectory in place; read-only arrays
    are replaced by writable copies."""
    for traj in results.values():
        for take in traj.keys():
            arr = traj[take]
            if not arr.flags.writeable:
                arr = arr.copy()
                traj[take] = arr
            arr[..., 32:35] = 0
            arr[..., 42:45] = 0
