"""BVH -> 30 Hz qpos trajectories (counterpart of
egopose_tpu/cli/convert_clip.py): every ``datasets/traj/<mocap-id>_*.bvh``
through the skeleton of ``<mocap-id>_<skt-id>.bvh`` into
``datasets/traj/<name>_traj.p``, a (T, nq) float64 numpy array.

    python -m egopose_tpu_torch.cli.convert_clip [--model-id humanoid_1205_v1] \\
        [--mocap-id 0213] [--skt-id take_01] [--range A B] [--mocap-fr 120] \\
        [--dt 0.0333] [--offset-z 0] [--device cuda|cpu]

The root quaternions of a whole take come from one batched float64 call
on ``--device``.  Reads datasets/ and assets/ relative to the working
directory (the model also from the repository's assets/).
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np


EXCLUDE_BONES = {"Thumb", "Index", "Middle", "Ring", "Pinky", "End", "Toe"}
SPEC_CHANNELS = {"LeftForeArm": ["Zrotation"], "RightForeArm": ["Zrotation"],
                 "LeftLeg": ["Xrotation"], "RightLeg": ["Xrotation"]}


def get_qpos_traj(poses, bone_addr, body_qposaddr, nq, device="cpu"):
    """BVH channel rows (T, channels) -> model qpos (T, nq), float64.  The
    root's euler angles are intrinsic xyz, so its quaternion is
    qx * qy * qz, for every frame at once on ``device``."""
    import torch
    from ..ops import quat as Q
    poses = np.asarray(poses, dtype=np.float64)
    qpos = np.zeros((poses.shape[0], nq))
    for bone_name, ind2 in body_qposaddr.items():
        if bone_name not in bone_addr:
            continue
        ind1 = bone_addr[bone_name]
        if ind1[0] == 0:
            angles = torch.as_tensor(poses[:, ind1[0] + 3:ind1[1]],
                                     device=device)
            eye = torch.eye(3, dtype=torch.float64, device=device)
            qx, qy, qz = (Q.axis_angle_to_quat(eye[i], angles[:, i])
                          for i in range(3))
            quat = Q.quat_mul(qx, Q.quat_mul(qy, qz))
            qpos[:, ind2[0]:ind2[0] + 3] = poses[:, ind1[0]:ind1[0] + 3]
            qpos[:, ind2[0] + 3:ind2[1]] = quat.cpu().numpy()
        else:
            qpos[:, ind2[0]:ind2[1]] = poses[:, ind1[0]:ind1[1]]
    return qpos


def main(argv=None):
    """Convert the takes; returns {traj file: (T, nq) qpos}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-id", type=str, default="humanoid_1205_v1")
    parser.add_argument("--mocap-id", type=str, default="0213")
    parser.add_argument("--range", type=int, nargs=2, default=None)
    parser.add_argument("--skt-id", type=str, default="take_01")
    parser.add_argument("--mocap-fr", type=int, default=120)
    parser.add_argument("--dt", type=float, default=1 / 30)
    parser.add_argument("--offset-z", type=float, default=0.0)
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without "
                             "CUDA), cpu runs on the CPU")
    args = parser.parse_args(argv)

    from .. import resolve_device
    from ..mocap import Skeleton, load_bvh_file, interpolated_traj
    from ..physics.spec import parse_mjcf
    from ..utils.assets import find_model_xml

    device = resolve_device(args.device)
    spec = parse_mjcf(find_model_xml(args.model_id))
    body_qposaddr = spec.body_qposaddr()

    skt_bvh = "datasets/traj/%s_%s.bvh" % (args.mocap_id, args.skt_id)
    skeleton = Skeleton()
    skeleton.load_from_bvh(skt_bvh, EXCLUDE_BONES, SPEC_CHANNELS)

    bvh_files = sorted(glob.glob("datasets/traj/%s_*.bvh" % args.mocap_id))
    if args.range is not None:
        bvh_files = bvh_files[args.range[0]:args.range[1]]
    out = {}
    for file in bvh_files:
        print("extracting trajectory from %s" % file)
        poses, bone_addr = load_bvh_file(file, skeleton)
        poses = interpolated_traj(poses, args.dt, mocap_fr=args.mocap_fr)
        qpos_traj = get_qpos_traj(poses, bone_addr, body_qposaddr, spec.nq,
                                  device)
        qpos_traj[:, 2] += args.offset_z
        name = os.path.splitext(os.path.basename(file))[0]
        traj_file = "%s/%s_traj.p" % (os.path.dirname(file), name)
        with open(traj_file, "wb") as f:
            pickle.dump(qpos_traj, f)
        print("saved", traj_file, qpos_traj.shape)
        out[traj_file] = qpos_traj
    return out


if __name__ == "__main__":
    main()
