"""AMC/BVH frame loading + resampling (counterpart of
egopose_tpu/mocap/pose.py, numpy only).

Both loaders are two-phase: build a column layout once, then convert all
frames with vectorized numpy ops.  Units: root translation length-scaled,
all angles degrees->radians, AMC per-bone value order reversed (the AMC
file stores channels rz..rx while the skeleton's dof order is rx..rz).
"""
from __future__ import annotations

import numpy as np

from .bvh import Bvh


def load_amc_file(fname, scale):
    """Parse an AMC motion file -> (poses (T, dof), bone_addr).

    Frames are delimited by integer marker lines; each following line is
    ``bone v1 v2 ...``.  Values are collected per bone across all frames and
    converted in one vectorized pass per bone.
    """
    per_bone: dict[str, list[list[float]]] = {}
    order: list[str] = []
    in_motion = False
    with open(fname) as f:
        for ln in f:
            w = ln.split()
            if not w or w[0].startswith((":", "#")):
                continue
            if w[0].lstrip("-").isdigit():
                in_motion = True
                continue
            if not in_motion:
                continue
            vals = [float(x) for x in w[1:]]
            if w[0] not in per_bone:
                per_bone[w[0]] = []
                order.append(w[0])
            per_bone[w[0]].append(vals)

    segments, bone_addr, col = [], {}, 0
    for name in order:
        arr = np.asarray(per_bone[name], dtype=float)
        if name == "root":
            # 3 translation values (length-scaled) + euler angles in degrees
            seg = np.hstack([arr[:, :3] * scale, np.radians(arr[:, 3:])])
        else:
            # file stores rz..rx; skeleton dof order is rx..rz -> reverse
            seg = np.radians(arr[:, ::-1])
        segments.append(seg)
        bone_addr[name] = (col, col + seg.shape[1])
        col += seg.shape[1]
    return np.hstack(segments), bone_addr


def load_bvh_file(fname, skeleton):
    """Load BVH motion frames re-ordered to a Skeleton's channel layout.

    One gather: a column-permutation from the BVH's global channel order to
    the skeleton's per-bone order, applied to the whole (T, channels) frame
    block at once.
    """
    with open(fname) as f:
        mocap = Bvh(f.read())

    cols, bone_addr, start = [], {}, 0
    for bone in skeleton.bones:
        j = mocap.get_joint(bone.name)
        cols.extend(j.channel_offset + j.channels.index(ch)
                    for ch in bone.channels)
        bone_addr[bone.name] = (start, start + len(bone.channels))
        start += len(bone.channels)

    raw = np.asarray(mocap.frames, dtype=float)[:, cols]
    poses = np.radians(raw)
    # the root's leading 3 channels are translation: length-scale, not angle
    s, _ = bone_addr[skeleton.root.name]
    poses[:, s:s + 3] = raw[:, s:s + 3] * skeleton.len_scale
    return poses, bone_addr


def lin_interp(pose1, pose2, t):
    return (1 - t) * pose1 + t * pose2


def interpolated_traj(poses, sample_t=0.030, mocap_fr=120):
    """Resample a (T, dof) trajectory to ``sample_t`` spacing by linear
    interpolation between the two nearest source frames (vectorized)."""
    n = poses.shape[0]
    num = int(np.floor((n - 1) / mocap_fr / sample_t))
    t = np.arange(num + 1) * (sample_t * mocap_fr)
    lo = np.floor(t).astype(int)
    hi = np.minimum(np.ceil(t).astype(int), n - 1)
    w = (t - lo)[:, None]
    return (1 - w) * poses[lo] + w * poses[hi]
