"""AgentEgo: video-conditioned PPO, sampling and updates (counterpart of
egopose_tpu/rl/agent_ego.py).

Holds the policy, value and video-context nets, the observation filter
(zstat) and the two optimizers; samples batches of segments through
rl/rollout.py and updates through rl/ppo.py.  Checkpoints are pickles in
the JAX package's layout (flax trees of numpy arrays + RunningStat), so
either package loads what the other saves; the reference code base's
checkpoints (torch state_dicts + a pickled ZFilter) load too.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..convert import params_from_jax, params_to_jax, save_checkpoint_pickle
from ..models.video_state_net import VideoStateNet
from ..ops import running_norm
from . import ppo, rollout
from .nets import PolicyGaussian, Value


class SampleLog(NamedTuple):
    num_steps: float
    num_episodes: float
    avg_episode_len: float
    avg_c_reward: float
    min_c_reward: float
    max_c_reward: float
    avg_c_info: np.ndarray
    fail_rate: float
    sample_time: float = 0.0


class AgentEgo:
    def __init__(self, model, spec, params, tables, expert, cnn_feat, cfg,
                 batch_lanes: int = 1024, seed: int = 1,
                 dtype=torch.float32, device="cpu"):
        self.model, self.spec, self.p, self.tables = model, spec, params, \
            tables
        self.dtype, self.device = dtype, torch.device(device)
        self.expert = expert
        self.cnn_feat = torch.as_tensor(np.asarray(cnn_feat)).to(
            device=self.device, dtype=dtype)
        self.cfg = cfg
        self.batch_lanes = batch_lanes
        self.end_reward = 0.0
        self.noise_rate = 1.0
        obs_dim = params.obs_dim
        # fresh weights come from a seeded generator without touching the
        # caller's global random state
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            (self.policy_net, self.value_net, self.policy_vs_net,
             self.value_vs_net) = self._make_nets(
                obs_dim, self.cnn_feat.shape[-1], spec.nu, cfg)
        for net in self.nets:
            net.to(device=self.device, dtype=dtype).eval()
        self.zstat = running_norm.init_stat(obs_dim, dtype, self.device)
        opt_p, opt_v = ppo.make_optimizers(
            [*self.policy_net.parameters(), *self.policy_vs_net.parameters()],
            [*self.value_net.parameters(), *self.value_vs_net.parameters()],
            cfg.policy_lr, cfg.value_lr, grad_clip=40.0,
            policy_weight_decay=cfg.policy_weightdecay,
            value_weight_decay=cfg.value_weightdecay)
        self.train_state = ppo.TrainState(
            policy=self.policy_net, policy_vs=self.policy_vs_net,
            value=self.value_net, value_vs=self.value_vs_net,
            opt_policy=opt_p, opt_value=opt_v)
        self.hyper = ppo.PPOHyper(
            gamma=cfg.gamma, tau=cfg.tau, clip_epsilon=cfg.clip_epsilon,
            num_epochs=cfg.num_optim_epoch,
            kl_target=float(getattr(cfg, "policy_kl_target", 0.0) or 0.0))
        # optional shuffled-minibatch PPO: cfg counts steps, the slices
        # are lane-grained
        mbs = getattr(cfg, "mini_batch_size", None)
        self.mini_batch_lanes = 0
        if mbs and mbs < batch_lanes * params.env_episode_len:
            self.mini_batch_lanes = max(1, int(mbs) // params.env_episode_len)
        self.update_generator = torch.Generator(device=self.device)
        self.update_generator.manual_seed(seed + 17)

    @staticmethod
    def _make_nets(obs_dim, cnn_fdim, nu, cfg):
        """(policy, value, policy context, value context) nets with fresh
        weights, made in this order."""
        return (PolicyGaussian(obs_dim + cfg.policy_v_hdim, nu,
                               cfg.policy_hsize, cfg.policy_htype,
                               cfg.log_std, cfg.fix_std),
                Value(obs_dim + cfg.value_v_hdim, cfg.value_hsize,
                      cfg.value_htype),
                VideoStateNet(cnn_fdim, cfg.policy_v_hdim, cfg.fr_margin,
                              cfg.policy_v_net, cfg.causal,
                              cfg.policy_v_net_param),
                VideoStateNet(cnn_fdim, cfg.value_v_hdim, cfg.fr_margin,
                              cfg.value_v_net, cfg.causal,
                              cfg.value_v_net_param))

    @property
    def nets(self):
        return (self.policy_net, self.policy_vs_net, self.value_net,
                self.value_vs_net)

    # -- the schedule's hooks (ego_mimic.py: pre-iteration updates) ---------
    def set_noise_rate(self, r):
        self.noise_rate = float(r)

    def set_policy_lr(self, lr):
        self.train_state.opt_policy.lr = float(lr)

    def fill_log_std(self, log_std):
        with torch.no_grad():
            self.policy_net.action_log_std.fill_(float(log_std))

    # -- sampling -------------------------------------------------------------
    def sample(self, generator: torch.Generator, min_batch_size: int,
               mean_action: bool = False):
        """ceil(min_batch_size / (lanes * episode_len)) segments, lanes
        concatenated.  Returns (SegmentBatch, SampleLog)."""
        t0 = time.time()
        per_seg = self.batch_lanes * self.p.env_episode_len
        n_seg = max(1, math.ceil(min_batch_size / per_seg))
        segs = []
        for _ in range(n_seg):
            noise = rollout.draw_segment_noise(
                self.p, self.expert, self.batch_lanes, self.noise_rate,
                generator)
            seg, self.zstat = self._rollout(noise, mean_action)
            segs.append(seg)
        batch = rollout.SegmentBatch(*[
            torch.cat(xs, 1 if xs[0].dim() > 1 else 0)
            for xs in zip(*segs)]) if n_seg > 1 else segs[0]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return batch, self._make_log(batch, time.time() - t0)

    def _rollout(self, noise, mean_action):
        """One segment from ``noise``: (SegmentBatch, new zstat)."""
        return rollout.rollout_segment(
            self.model, self.p, self.tables, self.expert, self.cnn_feat,
            self.policy_net, self.policy_vs_net, self.zstat, noise,
            mean_action, self.end_reward)

    def _make_log(self, batch, dt):
        valid = batch.valids.double().cpu().numpy()
        rewards = batch.rewards.double().cpu().numpy()
        fails = batch.fails.double().cpu().numpy()
        n_steps = valid.sum()
        # every lane is one episode, plus one per mid-segment re-anchor
        n_eps = valid.shape[1] + (fails * valid).sum()
        vsum = max(n_steps, 1.0)
        rv = rewards[valid > 0]
        info = batch.reward_info.double().cpu().numpy()
        return SampleLog(
            num_steps=float(n_steps), num_episodes=float(n_eps),
            avg_episode_len=float(n_steps / n_eps),
            avg_c_reward=float((rewards * valid).sum() / vsum),
            min_c_reward=float(rv.min()) if rv.size else 0.0,
            max_c_reward=float(rv.max()) if rv.size else 0.0,
            avg_c_info=(info * valid[..., None]).sum((0, 1)) / vsum,
            fail_rate=float((fails * valid).sum() / n_eps),
            sample_time=dt)

    # -- update ---------------------------------------------------------------
    def update_params(self, batch) -> dict:
        objective = getattr(self.cfg, "policy_objective", None) or "ppo"
        if objective != "ppo":
            raise NotImplementedError(
                f"policy_objective {objective!r} is not ported yet (ROADMAP "
                "§1 item 4: the a2c objective and TRPO)")
        _, metrics = ppo.ppo_update(
            self.train_state, self.hyper, batch, self._windows(batch),
            mini_batch_lanes=self.mini_batch_lanes,
            generator=self.update_generator)
        out = {k: float(v) for k, v in metrics.items()}
        # non-finite-gradient skips (Adam's apply_if_finite counters)
        for name in ("policy", "value"):
            opt = getattr(self.train_state, "opt_" + name)
            out[f"{name}_grad_skips"] = int(opt.total_notfinite)
        return out

    def _windows(self, batch):
        """The context nets' video windows of a batch's lanes."""
        return rollout.gather_windows(
            self.cnn_feat, batch.expert_ind, batch.start_ind,
            self.p.fr_margin, self.p.env_episode_len)

    # -- checkpoints ----------------------------------------------------------
    def checkpoint(self) -> dict:
        """The JAX package's checkpoint dict: flax trees + RunningStat, all
        numpy."""
        trees = params_to_jax(*[net.state_dict() for net in self.nets])
        np_ = lambda x: x.detach().cpu().numpy()
        return {"policy_dict": trees[0], "policy_vs_dict": trees[1],
                "value_dict": trees[2], "value_vs_dict": trees[3],
                "running_state": running_norm.RunningStat(
                    n=np_(self.zstat.n), mean=np_(self.zstat.mean),
                    s=np_(self.zstat.s))}

    def save(self, path: str):
        save_checkpoint_pickle(path, self.checkpoint())

    def load(self, path: str):
        """Load a checkpoint pickle written by either package's
        AgentEgo.save (flax trees + RunningStat) or by the reference code
        base (torch state_dicts + a pickled ZFilter), told apart by its
        contents."""
        from ..models.torch_import import tolerant_pickle_load
        self.load_checkpoint(tolerant_pickle_load(path))

    def _import_reference_checkpoint(self, cp: dict) -> dict:
        """A reference-format checkpoint -> the port's state_dicts, with
        the context nets' importer of this agent's kind."""
        from ..models import torch_import as ti
        cfg = self.cfg
        return ti.import_mimic_checkpoint(
            cp, bi_dir=not cfg.causal, v_net_type=cfg.policy_v_net,
            value_v_net_type=cfg.value_v_net)

    def load_checkpoint(self, cp: dict):
        from ..models.torch_import import looks_torch_state_dict
        stat = cp["running_state"]
        if looks_torch_state_dict(cp["policy_dict"]):
            cp = self._import_reference_checkpoint(cp)
            # reference checkpoints are float64: the session's dtype wins,
            # for the filter's statistics too (as in the JAX package)
            stat = running_norm.RunningStat(*[
                torch.as_tensor(np.asarray(x)).to(self.dtype)
                for x in cp["running_state"]])
            sds = [cp[k] for k in ("policy_dict", "policy_vs_dict",
                                   "value_dict", "value_vs_dict")]
        else:
            sds = params_from_jax(cp["policy_dict"], cp["policy_vs_dict"],
                                  cp["value_dict"], cp["value_vs_dict"])
        for net, sd in zip(self.nets, sds):
            net.load_state_dict({k: v.to(self.dtype) for k, v in sd.items()})
        self.zstat = running_norm.to_tensors(stat, self.device)
