"""Expert features by kinematic replay of mocap trajectories (counterpart
of egopose_tpu/cli/gen_expert.py): every take of ``datasets/meta/
<meta-id>.yml`` (its ``datasets/traj/<take>_traj.p``, hands zeroed) through
``envs.gen_expert_features`` in float64, each feature cut to the take's
video-mocap sync range, written as ``datasets/features/expert_<out-id>.p``
(dict take -> dict of numpy arrays, the JAX package's fields).

    python -m egopose_tpu_torch.cli.gen_expert --meta-id META --out-id ID \\
        [--model-xml assets/mujoco_models/humanoid_1205_v1.xml] \\
        [--device cuda|cpu]

On the card the replay of a take is one launch of the FK kernel K5 over
its frames.
"""
from __future__ import annotations

import argparse
import os
import pickle


def main(argv=None):
    """Write the expert file; returns the dict it holds."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--meta-id", default=None)
    parser.add_argument("--out-id", default=None)
    parser.add_argument("--model-xml",
                        default="assets/mujoco_models/humanoid_1205_v1.xml")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without "
                             "CUDA), cpu runs the plain PyTorch path")
    args = parser.parse_args(argv)

    import torch
    from .. import envs, resolve_device
    from ..data.dataset import Dataset
    from ..physics.model import build_model
    from ..physics.spec import parse_mjcf
    from ..utils.assets import find_model_xml
    from ..utils.config import EgoMimicConfig, make_env_params

    device = resolve_device(args.device)
    dtype = torch.float64
    cfg = EgoMimicConfig(None, create_dirs=False, cfg_dict={
        "meta_id": args.meta_id, "mujoco_model": "humanoid_1205_v1",
        "vis_model": "humanoid_1205_vis", "obs_coord": "heading"})
    spec = parse_mjcf(find_model_xml(args.model_xml))
    model = build_model(spec, dtype=dtype, device=device)
    tables = envs.make_body_tables(spec, device)
    p = make_env_params(cfg, spec, obs_dim=115, dtype=dtype, device=device)

    dataset = Dataset(args.meta_id, "all", 0, "iter", False, 0)
    expert_dict = {}
    num_sample = 0
    for i, take in enumerate(dataset.takes):
        _, lb, ub = dataset.msync[take]
        qpos = envs.zero_hands(spec, dataset.orig_trajs[i])
        feats = envs.gen_expert_features(
            model, p, tables, torch.as_tensor(qpos, dtype=dtype,
                                              device=device), dataset.dt)
        expert = {k: v.cpu().numpy()[lb:ub] for k, v in feats.items()
                  if k != "len"}
        expert["len"] = ub - lb
        expert["height_lb"] = expert["qpos"][:, 2].min()
        expert["head_height_lb"] = expert["head_pos"][:, 2].min()
        expert_dict[take] = expert
        num_sample += expert["len"]
        print(take, expert["len"], expert["qvel"].min(), expert["qvel"].max(),
              expert["head_height_lb"])

    print("meta: %s, total sample: %d, dataset length: %d"
          % (args.meta_id, num_sample, dataset.len))
    os.makedirs("datasets/features", exist_ok=True)
    path = "datasets/features/expert_%s.p" % args.out_id
    with open(path, "wb") as f:
        pickle.dump(expert_dict, f)
    print("saved", path)
    return expert_dict


if __name__ == "__main__":
    main()
