"""AgentEgo, inference half (counterpart of egopose_tpu/rl/agent_ego.py):
the policy, value and video-context nets, the observation filter (zstat)
and checkpoint loading.  Sampling and PPO updates belong to the training
slice."""
from __future__ import annotations

import torch

from ..convert import load_checkpoint_pickle, params_from_jax
from ..models.video_state_net import VideoStateNet
from ..ops import running_norm
from .nets import PolicyGaussian, Value


class AgentEgo:
    def __init__(self, spec, params, cnn_fdim: int, cfg, seed: int = 1,
                 dtype=torch.float32, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        obs_dim = params.obs_dim
        # untrained weights come from a seeded generator without touching
        # the caller's global random state
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.policy_net = PolicyGaussian(
                obs_dim + cfg.policy_v_hdim, spec.nu, cfg.policy_hsize,
                cfg.policy_htype, cfg.log_std)
            self.value_net = Value(obs_dim + cfg.value_v_hdim,
                                   cfg.value_hsize, cfg.value_htype)
            self.policy_vs_net = VideoStateNet(
                cnn_fdim, cfg.policy_v_hdim, cfg.fr_margin,
                cfg.policy_v_net, cfg.causal)
            self.value_vs_net = VideoStateNet(
                cnn_fdim, cfg.value_v_hdim, cfg.fr_margin, cfg.value_v_net,
                cfg.causal)
        for net in self.nets:
            net.to(device=self.device, dtype=dtype).eval()
        self.zstat = running_norm.RunningStat(
            n=torch.zeros((), dtype=dtype, device=self.device),
            mean=torch.zeros(obs_dim, dtype=dtype, device=self.device),
            s=torch.zeros(obs_dim, dtype=dtype, device=self.device))

    @property
    def nets(self):
        return (self.policy_net, self.policy_vs_net, self.value_net,
                self.value_vs_net)

    def load(self, path: str):
        """Load a checkpoint pickle written by the JAX package's
        AgentEgo.save (flax trees + RunningStat)."""
        self.load_checkpoint(load_checkpoint_pickle(path))

    def load_checkpoint(self, cp: dict):
        if "params" not in cp["policy_dict"]:
            raise NotImplementedError(
                "reference-format (torch state_dict) checkpoints are not "
                "ported; load a checkpoint written by egopose_tpu")
        sds = params_from_jax(cp["policy_dict"], cp["policy_vs_dict"],
                              cp["value_dict"], cp["value_vs_dict"])
        for net, sd in zip(self.nets, sds):
            net.load_state_dict({k: v.to(self.dtype) for k, v in sd.items()})
        self.zstat = running_norm.to_tensors(cp["running_state"],
                                             self.device)
