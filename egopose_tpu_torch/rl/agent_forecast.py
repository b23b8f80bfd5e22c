"""AgentForecast: PPO for ego-forecast (counterpart of
egopose_tpu/rl/agent_forecast.py).

Differences from ego-mimic: the video context is the final hidden state of
a causal LSTM over only the fr_margin past frames, fixed for the episode,
and an optional state LSTM runs through the rollout's step loop with its
carry (step mode) and unrolls over the batch in the update (batch mode).
A lane re-anchors only when it fails, at its current frame, and its state
LSTM restarts from zero.  Checkpoints keep the JAX package's layout.
"""
from __future__ import annotations

import torch

from .. import envs
from ..models.video_forecast_net import VideoForecastNet
from ..ops import running_norm
from ..utils.profile import span
from . import rollout
from .agent_ego import AgentEgo
from .distributions import diag_gaussian_sample
from .nets import PolicyGaussian, Value


def gather_past_windows(cnn_feat: torch.Tensor, expert_ind: torch.Tensor,
                        start_ind: torch.Tensor, margin: int) -> torch.Tensor:
    """Per-lane past-only CNN windows [start - margin, start) (N, margin,
    feat), sliced as jax.lax.dynamic_slice_in_dim slices."""
    return rollout.slice_windows(cnn_feat, expert_ind, start_ind - margin,
                                 margin)


def rollout_segment_forecast(model, p: envs.EnvParams, tables,
                             expert: envs.ExpertBatch, cnn_feat: torch.Tensor,
                             policy_net, policy_vs_net: VideoForecastNet,
                             zstat: running_norm.RunningStat,
                             noise: rollout.SegmentNoise,
                             mean_action: bool = False, end_reward=0.0,
                             z_clip: float = 5.0, group=None):
    """Sample one synchronized segment of ``env_episode_len`` steps from
    the lanes of ``noise``: the episode's video context computed once, the
    state LSTM's carry through the step loop.  A lane that fails is
    re-anchored to the expert pose at start_ind + cur_t (no random_cur_t
    wrap: an episode end does not re-anchor) and its carry restarts.
    ``group`` as in rollout.rollout_segment.  Returns (SegmentBatch, new
    zstat)."""
    t_len = p.env_episode_len
    with span("rollout.encode"):
        state = envs.reset_from(model, p, tables, expert, noise.expert_ind,
                                noise.start_ind, noise.cur_t0,
                                noise.init_noise)
        batch = state.qpos.shape[0]
        windows = gather_past_windows(cnn_feat, state.expert_ind,
                                      state.start_ind, p.fr_margin)
        obs0 = envs.observe(p, state)
        zstat = running_norm.push_batch(zstat, obs0, group=group)
        zobs = running_norm.apply(zstat, obs0, clip=z_clip)
        with torch.no_grad():
            v_out = policy_vs_net.encode_video(windows)    # (B, v_hdim)
            fresh = policy_vs_net.s_init_carry((batch,), zobs)

    def reanchor(st: envs.EnvState, anchor_noise) -> envs.EnvState:
        ind = st.start_ind + st.cur_t
        qpos = expert.qpos[st.expert_ind, ind].clone()
        qpos[:, 7:] += p.env_init_noise * anchor_noise
        bq = envs.get_body_quat(tables, qpos)
        return st._replace(qpos=qpos, qvel=expert.qvel[st.expert_ind, ind],
                           prev_qpos=qpos, prev_bquat=bq, bquat=bq,
                           done=torch.zeros_like(st.done))

    recs = []
    st = state
    no_exp = torch.zeros(batch, dtype=torch.bool, device=zobs.device)
    with torch.no_grad():
        s_carry = fresh
        for t in range(t_len):
            with span("rollout.step", t):
                with span("nets.context_step"):
                    s_carry, s_out = policy_vs_net.s_step(s_carry, zobs)
                with span("nets.policy"):
                    mean, log_std = policy_net(torch.cat([v_out, s_out], -1))
                    exp = no_exp if mean_action else noise.gate[t]
                    sampled = diag_gaussian_sample(mean, log_std,
                                                   noise=noise.act_noise[t])
                    action = torch.where(exp[:, None], sampled, mean)
                new_st, out = envs.step(model, p, tables, expert, st, action,
                                        end_reward)
                with span("env.reanchor"):
                    new_st = envs.select_state(
                        out.fail, reanchor(new_st, noise.anchor_noise[t]),
                        new_st)
                    s_carry = tuple(torch.where(out.fail[:, None], a, b)
                                    for a, b in zip(fresh, s_carry))
                    next_obs = torch.where(out.fail[:, None],
                                           envs.observe(p, new_st), out.obs)
                with span("env.filter_push"):
                    zstat = running_norm.push_batch(zstat, next_obs,
                                                    group=group)
                recs.append(rollout.SegmentBatch(
                    states=zobs, actions=action, rewards=out.reward,
                    masks=torch.where(out.done, 0.0, 1.0).to(zobs.dtype),
                    exps=exp.to(zobs.dtype),
                    valids=torch.ones(batch, dtype=zobs.dtype,
                                      device=zobs.device),
                    reward_info=out.reward_info, expert_ind=st.expert_ind,
                    start_ind=st.start_ind, fails=out.fail.to(zobs.dtype)))
                with span("env.filter_apply"):
                    zobs = running_norm.apply(zstat, next_obs, clip=z_clip)
                st = new_st
    seg = rollout.SegmentBatch(*[torch.stack(xs) for xs in zip(*recs)])
    return seg._replace(expert_ind=seg.expert_ind[0],
                        start_ind=seg.start_ind[0]), zstat


def warmstart_from_mimic(agent: "AgentForecast", mimic_cp: dict):
    """Copy an ego-mimic checkpoint's policy and value weights into the
    agent wherever the parameter exists and its shape matches: the first
    hidden layer of each (mimic input obs + v_hdim, forecast input v_hdim
    + s_dim) and the context nets are not copied.  ``mimic_cp`` is the
    JAX package's checkpoint dict (flax trees of numpy arrays) or a
    reference checkpoint already imported (the port's state_dicts,
    models/torch_import.py).  Returns the names of the copied parameters,
    per net."""
    from ..convert import params_from_jax
    if "params" in mimic_cp["policy_dict"]:
        sd_p, _, sd_v, _ = params_from_jax(
            mimic_cp["policy_dict"], {"params": {}},
            mimic_cp["value_dict"], {"params": {}})
    else:
        sd_p, sd_v = mimic_cp["policy_dict"], mimic_cp["value_dict"]
    copied = {}
    for name, net, src in (("policy", agent.policy_net, sd_p),
                           ("value", agent.value_net, sd_v)):
        dst = net.state_dict()
        keep = {k: v for k, v in src.items()
                if k in dst and dst[k].shape == v.shape}
        dst.update({k: v.to(dtype=dst[k].dtype, device=dst[k].device)
                    for k, v in keep.items()})
        net.load_state_dict(dst)
        copied[name] = sorted(keep)
    return copied


class AgentForecast(AgentEgo):
    """AgentEgo with the forecast context nets, sampler and windows."""

    @staticmethod
    def _make_nets(obs_dim, cnn_fdim, nu, cfg):
        pvs, vvs = (VideoForecastNet(
            cnn_fdim, obs_dim, getattr(cfg, f"{who}_v_hdim"), cfg.fr_margin,
            getattr(cfg, f"{who}_v_net"), getattr(cfg, f"{who}_s_hdim"),
            getattr(cfg, f"{who}_s_net"), getattr(cfg, f"{who}_dyn_v"),
            getattr(cfg, f"{who}_v_net_param"))
            for who in ("policy", "value"))
        return (PolicyGaussian(pvs.out_dim, nu, cfg.policy_hsize,
                               cfg.policy_htype, cfg.log_std, cfg.fix_std),
                Value(vvs.out_dim, cfg.value_hsize, cfg.value_htype),
                pvs, vvs)

    def _import_reference_checkpoint(self, cp: dict) -> dict:
        from ..models import torch_import as ti
        return ti.import_forecast_checkpoint(
            cp, policy_v_net=self.cfg.policy_v_net,
            value_v_net=self.cfg.value_v_net)

    def _rollout(self, noise, mean_action):
        return rollout_segment_forecast(
            self.model, self.p, self.tables, self.expert, self.cnn_feat,
            self.policy_net, self.policy_vs_net, self.zstat, noise,
            mean_action, self.end_reward, group=self.data)

    def _windows(self, batch):
        return gather_past_windows(self.cnn_feat, batch.expert_ind,
                                   batch.start_ind, self.p.fr_margin)
