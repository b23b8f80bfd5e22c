"""Batched humanoid imitation environment (counterpart of
egopose_tpu/envs/humanoid.py).

Pure functions over an explicit ``EnvState`` of tensors with the batch of
environments as the leading dimension (the JAX env is per-lane under
``vmap``).  Experts (mocap feature tracks) live in stacked padded tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import math_utils as M
from ..ops import quat as Q
from ..physics import engine
from ..physics.model import PhysicsModel
from ..physics.spec import ModelSpec


class ExpertBatch(NamedTuple):
    """All experts stacked into padded (E, Tmax, ...) tensors."""
    qpos: torch.Tensor          # (E,T,nq)
    qvel: torch.Tensor          # (E,T,nv)
    rlinv_local: torch.Tensor   # (E,T,3) root linear vel, obs_coord frame
    rangv: torch.Tensor         # (E,T,3) root angular vel, root frame
    rq_rmh: torch.Tensor        # (E,T,4) de-headed root quat
    ee_pos: torch.Tensor        # (E,T,15) end-effectors, obs_coord-relative
    ee_wpos: torch.Tensor       # (E,T,15) end-effectors, world
    bquat: torch.Tensor         # (E,T,4*nb) stacked body quats
    bangvel: torch.Tensor       # (E,T,3*nb) body angular velocities
    com: torch.Tensor           # (E,T,3)
    head_pos: torch.Tensor      # (E,T,3)
    obs: torch.Tensor           # (E,T,obs_dim)
    lens: torch.Tensor          # (E,) valid lengths
    height_lb: torch.Tensor     # (E,)
    head_height_lb: torch.Tensor  # (E,)


class EnvState(NamedTuple):
    """Carried state of a batch of environments (leading dim B)."""
    qpos: torch.Tensor
    qvel: torch.Tensor
    cur_t: torch.Tensor        # int64 control steps since episode start
    expert_ind: torch.Tensor   # int64
    start_ind: torch.Tensor    # int64
    prev_qpos: torch.Tensor
    prev_bquat: torch.Tensor
    bquat: torch.Tensor
    done: torch.Tensor         # bool


class StepOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    fail: torch.Tensor
    end: torch.Tensor
    reward_info: torch.Tensor  # (B,5) per-component rewards


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Environment configuration (the YAML subset the env math needs)."""
    obs_coord: str
    obs_vel: str
    obs_heading: bool
    obs_phase: bool
    root_deheading: bool
    env_episode_len: int
    fr_margin: int
    env_start_first: bool
    action_type: str
    frame_skip: int
    reward_id: str
    reward_decay: bool
    v_ord: int
    random_cur_t: bool
    nq: int
    nv: int
    nu: int
    obs_dim: int
    jkp: torch.Tensor
    jkd: torch.Tensor
    a_ref: torch.Tensor
    a_scale: torch.Tensor
    torque_lim: torch.Tensor
    env_init_noise: float
    w: torch.Tensor        # (5,) reward weights w_p, w_v, w_e, w_rp, w_rv
    k: torch.Tensor        # (7,) kernel scales k_p, k_v, k_e, k_rh, k_rq,
                           #      k_rl, k_ra
    b_diffw: torch.Tensor  # (nb-1,) per-body pose-diff weights
    contact: engine.ContactParams


class BodyTables(NamedTuple):
    euler_idx: torch.Tensor  # (nb-1,3) padded qpos index per non-root body
    ee_body: torch.Tensor    # (5,) body indices of the end effectors
    head_body: int


EE_NAMES = ["LeftFoot", "RightFoot", "LeftHand", "RightHand", "Head"]


def make_body_tables(spec: ModelSpec, device="cpu") -> BodyTables:
    """Index tables on ``device``, so the env's gathers copy nothing from
    the host inside a step."""
    qaddr = spec.body_qposaddr()
    euler_idx = np.full((spec.nbody - 1, 3), spec.nq, dtype=np.int64)
    for i, name in enumerate(spec.body_names[1:]):
        start, end = qaddr[name]
        for k in range(end - start):
            euler_idx[i, k] = start + k
    ee_body = np.array([spec.body_names.index(n) for n in EE_NAMES],
                       dtype=np.int64)
    return BodyTables(euler_idx=torch.as_tensor(euler_idx, device=device),
                      ee_body=torch.as_tensor(ee_body, device=device),
                      head_body=spec.body_names.index("Head"))


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------

def get_body_quat(tables: BodyTables, qpos: torch.Tensor) -> torch.Tensor:
    """Root quat followed by per-body quaternion_from_euler of that body's
    hinge angles in slot order (B, 4*nb)."""
    qpos_pad = torch.cat([qpos, qpos.new_zeros(qpos.shape[:-1] + (1,))], -1)
    e = qpos_pad[..., torch.as_tensor(tables.euler_idx, device=qpos.device)]
    bq = Q.quat_from_euler(e[..., 0], e[..., 1], e[..., 2])   # (...,nb-1,4)
    return torch.cat([qpos[..., 3:7], bq.flatten(-2)], -1)


def get_ee_pos(tables: BodyTables, kin: engine.Kin, qpos: torch.Tensor,
               transform: str | None) -> torch.Tensor:
    """End-effector body origins (B,15), optionally root-relative in the
    given coordinate frame."""
    pos = kin.xpos[:, torch.as_tensor(tables.ee_body, device=qpos.device)]
    if transform is None:
        return pos.flatten(-2)
    rel = M.transform_vec(pos - qpos[:, None, :3],
                          qpos[:, None, 3:7].expand(-1, 5, 4), transform)
    return rel.flatten(-2)


def get_obs(p: EnvParams, qpos: torch.Tensor, qvel: torch.Tensor,
            cur_t: torch.Tensor) -> torch.Tensor:
    """Observation (get_full_obs layout)."""
    v = M.transform_vec(qvel[:, :3], qpos[:, 3:7], p.obs_coord)
    qvel_t = torch.cat([v, qvel[:, 3:]], 1)
    parts = []
    if p.obs_heading:
        parts.append(M.get_heading(qpos[:, 3:7])[:, None])
    root_q = M.de_heading(qpos[:, 3:7]) if p.root_deheading else qpos[:, 3:7]
    parts += [qpos[:, 2:3], root_q, qpos[:, 7:]]
    if p.obs_vel == "root":
        parts.append(qvel_t[:, :6])
    elif p.obs_vel == "full":
        parts.append(qvel_t)
    if p.obs_phase:
        phase = torch.clamp(cur_t.to(qpos.dtype) / p.env_episode_len,
                            max=1.0)
        parts.append(phase[:, None])
    return torch.cat(parts, 1)


# ---------------------------------------------------------------------------
# rewards
# ---------------------------------------------------------------------------

def _end_bonus(is_end, end_reward, dtype):
    """end_reward where the episode ends, else 0, in ``dtype`` (a
    torch.where on Python scalars would round end_reward to float32)."""
    return is_end.to(dtype) * end_reward


def expert_frame(expert: ExpertBatch, state: EnvState) -> torch.Tensor:
    """The expert frame of each lane's current step, start_ind + cur_t,
    clamped to the stacked takes' last frame as the JAX env's gathers
    clamp it (a forecast window that ends at its take's end reads it at
    its last step)."""
    return torch.clamp(state.start_ind + state.cur_t,
                       max=expert.qpos.shape[1] - 1)


def quat_space_reward_v3(p: EnvParams, expert: ExpertBatch, state: EnvState,
                         cur_ee, dt, end_reward, is_end):
    """Weighted product-of-exponential-kernels imitation reward
    (reward_function.py:4-60)."""
    w_p, w_v, w_e, w_rp, w_rv = p.w
    k_p, k_v, k_e, k_rh, k_rq, k_rl, k_ra = p.k
    ind = expert_frame(expert, state)
    e = state.expert_ind

    cur_qpos = state.qpos
    cur_qvel = M.get_qvel_fd(state.prev_qpos, cur_qpos, dt, p.obs_coord)
    cur_rq_rmh = M.de_heading(cur_qpos[:, 3:7])
    cur_bangvel = M.get_angvel_fd(state.prev_bquat, state.bquat, dt)

    e_qpos = expert.qpos[e, ind]
    pose_diff = M.multi_quat_norm(M.multi_quat_diff(state.bquat[:, 4:],
                                                    expert.bquat[e, ind, 4:]))
    pose_dist = torch.linalg.vector_norm(pose_diff * p.b_diffw, dim=-1)
    pose_reward = torch.exp(-k_p * pose_dist ** 2)
    vel_dist = torch.linalg.vector_norm(
        cur_bangvel[:, 3:] - expert.bangvel[e, ind, 3:], ord=p.v_ord, dim=-1)
    vel_reward = torch.exp(-k_v * vel_dist ** 2)
    ee_dist = torch.linalg.vector_norm(cur_ee - expert.ee_pos[e, ind], dim=-1)
    ee_reward = torch.exp(-k_e * ee_dist ** 2)
    root_height_dist = cur_qpos[:, 2] - e_qpos[:, 2]
    root_quat_dist = M.multi_quat_norm(
        M.multi_quat_diff(cur_rq_rmh, expert.rq_rmh[e, ind]))[:, 0]
    root_pose_reward = torch.exp(-k_rh * root_height_dist ** 2
                                 - k_rq * root_quat_dist ** 2)
    root_linv_dist = torch.linalg.vector_norm(
        cur_qvel[:, :3] - expert.rlinv_local[e, ind], dim=-1)
    root_angv_dist = torch.linalg.vector_norm(
        cur_qvel[:, 3:6] - expert.rangv[e, ind], dim=-1)
    root_vel_reward = torch.exp(-k_rl * root_linv_dist ** 2
                                - k_ra * root_angv_dist ** 2)

    reward = (w_p * pose_reward + w_v * vel_reward + w_e * ee_reward
              + w_rp * root_pose_reward + w_rv * root_vel_reward)
    reward = reward / (w_p + w_v + w_e + w_rp + w_rv)
    if p.reward_decay:
        reward = reward * (1.0 - state.cur_t.to(reward.dtype)
                           / p.env_episode_len)
    reward = reward + _end_bonus(is_end, end_reward, reward.dtype)
    comps = torch.stack([pose_reward, vel_reward, ee_reward,
                         root_pose_reward, root_vel_reward], -1)
    return reward, comps


def constant_reward(p, expert, state, cur_ee, dt, end_reward, is_end):
    r = 1.0 + _end_bonus(is_end, end_reward, state.qpos.dtype)
    return r, state.qpos.new_zeros(state.qpos.shape[0], 5)


def pose_dist_reward(p, expert, state, cur_ee, dt, end_reward, is_end):
    ind = expert_frame(expert, state)
    diff = expert.qpos[state.expert_ind, ind] - state.qpos
    pose_dist = torch.linalg.vector_norm(diff[:, 2:], dim=-1)
    r = 5.0 - 3.0 * pose_dist + _end_bonus(is_end, end_reward,
                                            pose_dist.dtype)
    comps = torch.cat([pose_dist[:, None],
                       state.qpos.new_zeros(state.qpos.shape[0], 4)], 1)
    return r, comps


REWARD_FUNCS = {"quat_v3": quat_space_reward_v3,
                "constant": constant_reward,
                "pose_dist": pose_dist_reward}


# ---------------------------------------------------------------------------
# reset / step
# ---------------------------------------------------------------------------

def draw_reset(p: EnvParams, expert: ExpertBatch,
               generator: torch.Generator, batch: int, fix_expert_ind=None,
               fix_start_ind=None):
    """The random draws of a batched reset (reset_model semantics), from
    ``generator``: expert take in [0, E), start frame in [fr_margin,
    max(len - episode_len - fr_margin, fr_margin + 1)) (0 with
    env_start_first), the random_cur_t start step in [0, episode_len), and
    standard-normal joint noise (B, nq-7).  Returns (expert_ind, start_ind,
    cur_t0, init_noise)."""
    dev = expert.qpos.device
    n_expert = expert.qpos.shape[0]
    draw = lambda lo, hi: torch.floor(
        lo + (hi - lo) * torch.rand(batch, generator=generator, device=dev,
                                    dtype=torch.float64)).to(torch.int64)
    zeros = torch.zeros(batch, dtype=torch.int64, device=dev)
    if fix_expert_ind is None:
        expert_ind = draw(0, n_expert)
    else:
        expert_ind = torch.as_tensor(fix_expert_ind, device=dev).expand(batch)
    if fix_start_ind is not None:
        start_ind = torch.as_tensor(fix_start_ind, device=dev).expand(batch)
    elif p.env_start_first:
        start_ind = zeros
    else:
        hi = expert.lens[expert_ind] - p.env_episode_len - p.fr_margin
        hi = torch.clamp(hi, min=p.fr_margin + 1)
        start_ind = draw(p.fr_margin, hi.to(torch.float64))
    if p.random_cur_t and fix_start_ind is None:
        cur_t0 = draw(0, p.env_episode_len)
    else:
        cur_t0 = zeros
    init_noise = torch.randn(batch, p.nq - 7, generator=generator,
                             device=dev, dtype=expert.qpos.dtype)
    return expert_ind, start_ind, cur_t0, init_noise


def reset_from(model: PhysicsModel, p: EnvParams, tables: BodyTables,
               expert: ExpertBatch, expert_ind, start_ind, cur_t0,
               init_noise) -> EnvState:
    """Episode initialization from the expert state at start_ind + cur_t0,
    with env_init_noise * init_noise on the joints."""
    init_ind = start_ind + cur_t0
    qpos = expert.qpos[expert_ind, init_ind].clone()
    qvel = expert.qvel[expert_ind, init_ind].clone()
    qpos[:, 7:] += p.env_init_noise * init_noise.to(qpos.dtype)
    bq = get_body_quat(tables, qpos)
    return EnvState(qpos=qpos, qvel=qvel, cur_t=cur_t0.to(torch.int64),
                    expert_ind=expert_ind.to(torch.int64).clone(),
                    start_ind=start_ind.to(torch.int64).clone(),
                    prev_qpos=qpos, prev_bquat=bq, bquat=bq,
                    done=torch.zeros(qpos.shape[0], dtype=torch.bool,
                                     device=qpos.device))


def reset(model: PhysicsModel, p: EnvParams, tables: BodyTables,
          expert: ExpertBatch, generator: torch.Generator, batch: int,
          fix_expert_ind=None, fix_start_ind=None) -> EnvState:
    """Episode initialization for ``batch`` environments, its random draws
    from ``generator`` (draw_reset, then reset_from)."""
    return reset_from(model, p, tables, expert, *draw_reset(
        p, expert, generator, batch, fix_expert_ind, fix_start_ind))


def apply_action(p: EnvParams, action: torch.Tensor) -> torch.Tensor:
    """Action -> PD target / torque."""
    return p.a_ref + action * p.a_scale


def step(model: PhysicsModel, p: EnvParams, tables: BodyTables,
         expert: ExpertBatch, state: EnvState, action: torch.Tensor,
         end_reward=0.0, fix_len: int | None = None, fix_head_lb=None):
    """One 30 Hz control step for the batch: 15 physics substeps (stable
    PD in position mode: the K1 kernel on the card; held torques in torque
    mode: the K2 solve on the card), then obs, reward and fail/end
    detection."""
    ctrl = apply_action(p, action)
    if p.action_type == "position":
        qpos, qvel = engine.pd_control_step(
            model, state.qpos, state.qvel, ctrl, p.jkp, p.jkd, p.torque_lim,
            p.frame_skip, p.contact)
    else:
        qpos, qvel = engine.torque_control_step(
            model, state.qpos, state.qvel, ctrl, p.torque_lim, p.frame_skip,
            p.contact)
    return finish_step(model, p, tables, expert, state, qpos, qvel,
                       end_reward, fix_len, fix_head_lb)


def finish_step(model: PhysicsModel, p: EnvParams, tables: BodyTables,
                expert: ExpertBatch, state: EnvState, qpos, qvel,
                end_reward=0.0, fix_len: int | None = None, fix_head_lb=None):
    """Post-physics half of ``step``.  Divergence guard: a non-finite or
    absurd-velocity (|qvel| > 1e8) lane ends its episode as a failure, its
    state is reset to the pre-step qpos and zero qvel, and its reward is 0,
    so no NaN reaches obs, reward or the learner."""
    dt = model.timestep * p.frame_skip
    cur_t = state.cur_t + 1
    diverged = ~(torch.isfinite(qpos).all(1) & torch.isfinite(qvel).all(1)) \
        | (torch.amax(torch.abs(qvel), 1) > 1e8)
    qpos = torch.where(diverged[:, None], state.qpos, qpos)
    qvel = torch.where(diverged[:, None], torch.zeros_like(qvel), qvel)
    bq = get_body_quat(tables, qpos)
    new_state = EnvState(qpos=qpos, qvel=qvel, cur_t=cur_t,
                         expert_ind=state.expert_ind,
                         start_ind=state.start_ind,
                         prev_qpos=state.qpos, prev_bquat=state.bquat,
                         bquat=bq, done=state.done)

    kin = engine.fk(model, qpos)
    head_z = kin.xpos[:, tables.head_body, 2]
    if fix_head_lb is not None:
        fail = head_z < fix_head_lb
    else:
        fail = head_z < expert.head_height_lb[state.expert_ind] - 0.1
    fail = fail | diverged
    ep_len = p.env_episode_len if fix_len is None else fix_len
    end = cur_t >= ep_len
    done = fail | end

    cur_ee = get_ee_pos(tables, kin, qpos, p.obs_coord)
    reward_fn = REWARD_FUNCS[p.reward_id]
    reward, comps = reward_fn(p, expert, new_state, cur_ee, dt, end_reward,
                              end)
    reward = torch.where(diverged, torch.zeros_like(reward), reward)
    comps = torch.where(diverged[:, None], torch.zeros_like(comps), comps)

    obs = get_obs(p, qpos, qvel, cur_t)
    new_state = new_state._replace(done=done)
    return new_state, StepOut(obs=obs, reward=reward, done=done, fail=fail,
                              end=end, reward_info=comps)


def observe(p: EnvParams, state: EnvState) -> torch.Tensor:
    """Observation of the current state (used after reset)."""
    return get_obs(p, state.qpos, state.qvel, state.cur_t)


def select_state(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per-lane choice between two EnvStates: ``a`` where ``mask``."""
    return type(a)(*[torch.where(
        mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y)
        for x, y in zip(a, b)])
