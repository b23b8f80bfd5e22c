"""Mocap parsing: BVH / AMC / ASF files, skeletons and their MJCF
(counterpart of egopose_tpu/mocap, numpy only)."""
from .bvh import Bvh, BvhJoint  # noqa: F401
from .skeleton import Skeleton, Bone  # noqa: F401
from .pose import (load_amc_file, load_bvh_file, interpolated_traj,  # noqa: F401
                   lin_interp)
