"""Humanoid MJCF from a BVH skeleton (counterpart of
egopose_tpu/cli/create_humanoid.py): the skeleton of
``datasets/traj/<mocap-id>_<skt-id>.bvh`` written into the template
``assets/mujoco_models/template/<template-id>.xml`` (the working
directory's, else the repository's) as
``assets/mujoco_models/<out-id>.xml``.

    python -m egopose_tpu_torch.cli.create_humanoid [--mocap-id 1205] \\
        [--skt-id take_01] [--template-id humanoid_template] [--out-id ID]

XML work only: it takes no device.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Write the model; returns its path."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--mocap-id", type=str, default="1205")
    parser.add_argument("--skt-id", type=str, default="take_01")
    parser.add_argument("--template-id", type=str, default="humanoid_template")
    parser.add_argument("--out-id", type=str, default=None)
    args = parser.parse_args(argv)

    from ..mocap import Skeleton
    from ..utils.assets import REPO_ROOT
    from .convert_clip import EXCLUDE_BONES, SPEC_CHANNELS

    bvh = "datasets/traj/%s_%s.bvh" % (args.mocap_id, args.skt_id)
    skeleton = Skeleton()
    skeleton.load_from_bvh(bvh, EXCLUDE_BONES, SPEC_CHANNELS)
    out_id = args.out_id or ("humanoid_%s_orig" % args.mocap_id)
    os.makedirs("assets/mujoco_models", exist_ok=True)
    out = "assets/mujoco_models/%s.xml" % out_id
    rel = "assets/mujoco_models/template/%s.xml" % args.template_id
    template = rel if os.path.exists(rel) else os.path.join(REPO_ROOT, rel)
    if not os.path.exists(template):
        raise SystemExit(f"template not found: {rel} (generate it with "
                         "egopose_tpu_torch.physics.spec.write_vis_family)")
    skeleton.write_xml(out, template_fname=template)
    print("wrote", out, "from template", template)
    return out


if __name__ == "__main__":
    main()
