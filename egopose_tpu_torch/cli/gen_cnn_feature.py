"""CNN feature extraction (counterpart of
egopose_tpu/cli/gen_cnn_feature.py): stream every take's optical flow
through the trained statereg CNN in batches of ``--batch`` frames and
write datasets/features/cnn_feat_<out-id>.p as (dict take -> (T, cnn_fdim)
features, the checkpoint's mean), the JAX package's layout.

    python -m egopose_tpu_torch.cli.gen_cnn_feature --meta-id META \\
        --out-id ID --statereg-cfg CFG [--statereg-iter 100] \\
        [--batch 256] [--synthetic] [--device cuda|cpu]

The statereg checkpoint may be in either package's layout or the
reference's.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch


def main(argv=None, batch_hook=None):
    """``batch_hook(take, start, frames, features)``, if given, is called
    with each batch's (padded) frames on the device and their features."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--meta-id", default=None)
    parser.add_argument("--out-id", default=None)
    parser.add_argument("--statereg-cfg", default=None)
    parser.add_argument("--statereg-iter", type=int, default=100)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--synthetic", action="store_true", default=False)
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without "
                             "CUDA)")
    args = parser.parse_args(argv)

    from .. import resolve_device
    from ..data.dataset import Dataset
    from ..utils.config import StateRegConfig
    from .state_reg import load_state_net, make_net, pad_flow_channels

    device = resolve_device(args.device)
    cfg = StateRegConfig(args.statereg_cfg, create_dirs=False)
    dataset = Dataset(args.meta_id, "all", 0, "iter", False, 0,
                      synthetic=args.synthetic)
    sd, meta = load_state_net(
        cfg, "%s/iter_%04d.p" % (cfg.model_dir, args.statereg_iter),
        no_cnn=False)
    frame_shape = dataset.load_of(0, 0, 1).shape[1:3] + (3,)
    state_dim = (dataset.traj_dim - 1) // 2 + 6 if cfg.pose_only \
        else dataset.traj_dim
    net = make_net(cfg, state_dim, False, frame_shape, cfg.seed).to(
        device=device, dtype=torch.float32)
    net.load_state_dict(sd)
    net.eval()

    cnn_feat_dict = {}
    with torch.no_grad():
        for ti, take in enumerate(dataset.takes):
            im_offset, lb, ub = dataset.msync[take]
            feats = []
            for s in range(lb, ub, args.batch):
                e = min(s + args.batch, ub)
                of = dataset.load_of(ti, s + im_offset, e + im_offset)
                pad = args.batch - of.shape[0]
                if pad:       # a whole batch, the last frame repeated
                    of = np.concatenate([of, np.repeat(of[-1:], pad, 0)])
                frames = pad_flow_channels(torch.from_numpy(
                    np.ascontiguousarray(of)).to(device))
                f = net.cnn_feature(frames)
                if batch_hook is not None:
                    batch_hook(take, s, frames, f)
                feats.append(f[:e - s].cpu().numpy())
            cnn_feat_dict[take] = np.vstack(feats)
            print(take, cnn_feat_dict[take].shape)

    os.makedirs("datasets/features", exist_ok=True)
    path = "datasets/features/cnn_feat_%s.p" % args.out_id
    with open(path, "wb") as f:
        pickle.dump((cnn_feat_dict, meta.get("mean")), f)
    print("saved", path)
    return cnn_feat_dict


if __name__ == "__main__":
    main()
