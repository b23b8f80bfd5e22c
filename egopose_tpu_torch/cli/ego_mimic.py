"""Ego-mimic world construction (counterpart of
egopose_tpu/cli/ego_mimic.py::build_world).  The training entry point
belongs to the training slice."""
from __future__ import annotations

import os
import pickle

import numpy as np


def build_world(cfg, dtype, device, synthetic=False, synthetic_takes=None,
                synthetic_len=None, model_xml=None, data="train"):
    """Physics model + experts + CNN features for a config, on ``device``.

    ``data`` selects the take split whose experts and features load.  The
    synthetic world defaults to 4 takes x 400 frames, overridable with
    EGOPOSE_SYNTHETIC_TAKES / EGOPOSE_SYNTHETIC_LEN; it is drawn from
    np.random.RandomState(cfg.seed) exactly as the JAX package draws it, so
    both packages see the same experts and features."""
    from .. import envs
    from ..physics.model import build_model
    from ..physics.spec import parse_mjcf
    from ..utils.assets import find_model_xml
    from ..utils.config import apply_model_params, make_env_params
    if synthetic_takes is None:
        synthetic_takes = int(os.environ.get("EGOPOSE_SYNTHETIC_TAKES", 4))
    if synthetic_len is None:
        synthetic_len = int(os.environ.get("EGOPOSE_SYNTHETIC_LEN", 400))
    xml = find_model_xml(model_xml or cfg.mujoco_model)
    spec = apply_model_params(parse_mjcf(xml), cfg)
    model = build_model(spec, dtype=dtype, device=device)
    tables = envs.make_body_tables(spec)
    obs_dim = (1 if cfg.obs_heading else 0) + (spec.nq - 2) \
        + {"root": 6, "full": spec.ndof}.get(cfg.obs_vel, 0) \
        + (1 if cfg.obs_phase else 0)
    p = make_env_params(cfg, spec, obs_dim=obs_dim, dtype=dtype,
                        device=device)

    if not synthetic and cfg.expert_feat_file \
            and os.path.exists(cfg.expert_feat_file):
        with open(cfg.expert_feat_file, "rb") as f:
            expert_dict = pickle.load(f)
        expert = envs.stack_experts([expert_dict[t] for t in cfg.takes[data]],
                                    device=device)
        with open(cfg.cnn_feat_file, "rb") as f:
            cnn = pickle.load(f)
        cnn_feat_dict = cnn[0] if isinstance(cnn, tuple) else cnn
        feats = [np.asarray(cnn_feat_dict[t]) for t in cfg.takes[data]]
        tmax = int(expert.qpos.shape[1])
        cnn_feat = np.zeros((len(feats), tmax, feats[0].shape[-1]),
                            np.float32)
        for i, f in enumerate(feats):
            n = min(tmax, f.shape[0])
            cnn_feat[i, :n] = f[:n]
            cnn_feat[i, n:] = f[n - 1]
    else:
        expert = envs.synthetic_experts(model, p, tables, spec,
                                        n_takes=synthetic_takes,
                                        t_len=synthetic_len, seed=cfg.seed)
        rng = np.random.RandomState(cfg.seed)
        # synthetic "CNN features": noisy linear projection of expert obs
        proj = rng.randn(expert.obs.shape[-1], 64).astype(np.float32) / 8
        obs = expert.obs.detach().cpu().numpy().astype(np.float32)
        cnn_feat = np.einsum("etf,fc->etc", obs, proj)
        cnn_feat += 0.1 * rng.randn(*cnn_feat.shape).astype(np.float32)
    expert = type(expert)(*[x.to(dtype) if x.is_floating_point() else x
                            for x in expert])
    return spec, model, tables, p, expert, np.asarray(cnn_feat)
