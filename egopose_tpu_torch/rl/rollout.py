"""Batched on-device rollout sampler (counterpart of
egopose_tpu/rl/rollout.py).

Lanes run in synchronized segments of ``env_episode_len`` steps.  Each
segment starts with a batched reset and one bidirectional-LSTM pass over
the per-lane CNN-feature windows; a lane that fails mid-segment (head below
the expert bound; with ``random_cur_t`` also one that reaches its episode
end) is re-anchored to the expert pose at its current frame -- a new
episode in the same context window, recorded with mask 0 at that step so
GAE never bootstraps across it.

Every random number of a segment (reset indices and joint noise, the
Bernoulli exploration gates, the action noise, the re-anchor noise) comes
from ``draw_segment_noise``, drawn before the step loop; a test can pass
its own ``SegmentNoise`` instead.  The step loop reads nothing back to the
host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import envs
from ..ops import running_norm
from .distributions import diag_gaussian_sample


class SegmentBatch(NamedTuple):
    """One segment of transitions, time-major (T, B, ...)."""
    states: torch.Tensor       # (T,B,obs) z-filtered observations
    actions: torch.Tensor      # (T,B,nu)
    rewards: torch.Tensor      # (T,B)
    masks: torch.Tensor        # (T,B) 0 where the episode ended at this step
    exps: torch.Tensor         # (T,B) 1 where the action was sampled
    valids: torch.Tensor       # (T,B) 1 for real transitions
    reward_info: torch.Tensor  # (T,B,5)
    expert_ind: torch.Tensor   # (B,)
    start_ind: torch.Tensor    # (B,)
    fails: torch.Tensor        # (T,B) 1 where the lane was re-anchored


class SegmentNoise(NamedTuple):
    """All random numbers of one segment of T steps over B lanes."""
    expert_ind: torch.Tensor    # (B,) reset take
    start_ind: torch.Tensor     # (B,) reset start frame
    cur_t0: torch.Tensor        # (B,) reset step (random_cur_t)
    init_noise: torch.Tensor    # (B,nq-7) standard normal, reset joints
    gate: torch.Tensor          # (T,B) bool, exploration gate
    act_noise: torch.Tensor     # (T,B,nu) standard normal, action noise
    anchor_noise: torch.Tensor  # (T,B,nq-7) standard normal, re-anchor


def draw_segment_noise(p: envs.EnvParams, expert: envs.ExpertBatch,
                       batch: int, noise_rate: float,
                       generator: torch.Generator) -> SegmentNoise:
    """Draw every random number of one segment from ``generator``."""
    t_len, dev, dtype = p.env_episode_len, expert.qpos.device, \
        expert.qpos.dtype
    reset = envs.draw_reset(p, expert, generator, batch)
    normal = lambda *shape: torch.randn(shape, generator=generator,
                                        device=dev, dtype=dtype)
    gate = torch.rand(t_len, batch, generator=generator, device=dev,
                      dtype=dtype) < noise_rate
    return SegmentNoise(*reset, gate=gate,
                        act_noise=normal(t_len, batch, p.nu),
                        anchor_noise=normal(t_len, batch, p.nq - 7))


def gather_windows(cnn_feat: torch.Tensor, expert_ind: torch.Tensor,
                   start_ind: torch.Tensor, margin: int,
                   ep_len: int) -> torch.Tensor:
    """Per-lane CNN-feature windows [start-margin, start+ep_len+margin)
    (N, W, feat), indexed as jax.lax.dynamic_slice_in_dim indexes: a
    negative start counts from the take's end, and a window that would
    leave the take is shifted back inside.  (Resets draw start_ind >=
    margin, so the rollout's windows never need either.)"""
    return slice_windows(cnn_feat, expert_ind, start_ind - margin,
                         ep_len + 2 * margin)


def slice_windows(cnn_feat: torch.Tensor, expert_ind: torch.Tensor,
                  start: torch.Tensor, width: int) -> torch.Tensor:
    """Per-lane frames [start, start+width) of each lane's take (N, width,
    feat), as jax.lax.dynamic_slice_in_dim slices: a negative start counts
    from the take's end, then the window is clamped inside the take."""
    t_max = cnn_feat.shape[1]
    start = torch.clamp(torch.where(start < 0, start + t_max, start), 0,
                        t_max - width)
    idx = start[:, None] + torch.arange(width, device=cnn_feat.device)
    return cnn_feat[expert_ind[:, None], idx]


def rollout_segment(model, p: envs.EnvParams, tables, expert: envs.ExpertBatch,
                    cnn_feat: torch.Tensor, policy_net, policy_vs_net,
                    zstat: running_norm.RunningStat, noise: SegmentNoise,
                    mean_action: bool = False, end_reward=0.0,
                    z_clip: float = 5.0, group=None):
    """Sample one synchronized segment of ``env_episode_len`` steps from
    the lanes of ``noise``.  ``policy_vs_net`` is any callable from
    windows to context (the time-sharded encode under sequence
    parallelism); ``group`` (parallel/mesh.Group) merges the observation
    filter over every rank's lanes.  Returns (SegmentBatch, new zstat)."""
    t_len = p.env_episode_len
    state = envs.reset_from(model, p, tables, expert, noise.expert_ind,
                            noise.start_ind, noise.cur_t0, noise.init_noise)
    batch = state.qpos.shape[0]
    windows = gather_windows(cnn_feat, state.expert_ind, state.start_ind,
                             p.fr_margin, t_len)
    with torch.no_grad():
        v_out = policy_vs_net(windows)                     # (B,T,v_hdim)
    obs0 = envs.observe(p, state)
    zstat = running_norm.push_batch(zstat, obs0, group=group)
    zobs = running_norm.apply(zstat, obs0, clip=z_clip)

    def reanchor(st: envs.EnvState, anchor_noise) -> envs.EnvState:
        """Restart from the expert pose at the current frame (same take,
        same context window, env_init_noise on the joints); a random_cur_t
        end restarts at cur_t = 0."""
        cur_t = torch.where(st.cur_t >= p.env_episode_len,
                            torch.zeros_like(st.cur_t), st.cur_t)
        ind = st.start_ind + cur_t
        qpos = expert.qpos[st.expert_ind, ind].clone()
        qpos[:, 7:] += p.env_init_noise * anchor_noise
        bq = envs.get_body_quat(tables, qpos)
        return st._replace(qpos=qpos, qvel=expert.qvel[st.expert_ind, ind],
                           prev_qpos=qpos, prev_bquat=bq, bquat=bq,
                           cur_t=cur_t, done=torch.zeros_like(st.done))

    recs = []
    st = state
    no_exp = torch.zeros(batch, dtype=torch.bool, device=zobs.device)
    with torch.no_grad():
        for t in range(t_len):
            mean, log_std = policy_net(torch.cat([v_out[:, t], zobs], -1))
            exp = no_exp if mean_action else noise.gate[t]
            sampled = diag_gaussian_sample(mean, log_std,
                                           noise=noise.act_noise[t])
            action = torch.where(exp[:, None], sampled, mean)
            new_st, out = envs.step(model, p, tables, expert, st, action,
                                    end_reward)
            trigger = out.done if p.random_cur_t else out.fail
            new_st = envs.select_state(
                trigger, reanchor(new_st, noise.anchor_noise[t]), new_st)
            next_obs = torch.where(trigger[:, None], envs.observe(p, new_st),
                                   out.obs)
            zstat = running_norm.push_batch(zstat, next_obs, group=group)
            recs.append(SegmentBatch(
                states=zobs, actions=action, rewards=out.reward,
                masks=torch.where(out.done, 0.0, 1.0).to(zobs.dtype),
                exps=exp.to(zobs.dtype),
                valids=torch.ones(batch, dtype=zobs.dtype,
                                  device=zobs.device),
                reward_info=out.reward_info, expert_ind=st.expert_ind,
                start_ind=st.start_ind, fails=trigger.to(zobs.dtype)))
            zobs = running_norm.apply(zstat, next_obs, clip=z_clip)
            st = new_st
    seg = SegmentBatch(*[torch.stack(xs) for xs in zip(*recs)])
    return seg._replace(expert_ind=seg.expert_ind[0],
                        start_ind=seg.start_ind[0]), zstat
