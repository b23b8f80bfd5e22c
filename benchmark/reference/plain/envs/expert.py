"""Expert features by batched kinematic replay of mocap trajectories
(counterpart of egopose_tpu/envs/expert.py)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops import math_utils as M
from ..physics import engine
from ..physics.fk import fk_batched
from ..physics.model import PhysicsModel
from ..physics.spec import ModelSpec
from .humanoid import (BodyTables, EnvParams, ExpertBatch, get_body_quat,
                       get_ee_pos, get_obs)


def zero_hands(spec: ModelSpec, qpos: np.ndarray) -> np.ndarray:
    """Zero the noisy hand joints."""
    qaddr = spec.body_qposaddr()
    qpos = np.array(qpos)
    for name in ("LeftHand", "RightHand"):
        s, e = qaddr[name]
        qpos[..., s:e] = 0.0
    return qpos


def gen_expert_features(model: PhysicsModel, p: EnvParams, tables: BodyTables,
                        qpos_traj: torch.Tensor, dt: float) -> dict:
    """Per-frame expert features of one take, (T, ...) tensors under the
    reference's field names.  The expert obs uses zero velocities, as the
    reference's replay never writes qvel.  The take's FK is one
    ``fk_batched`` call: one launch of the FK kernel K5 over its T frames
    on a CUDA model (``qpos_traj`` in the model's dtype), the plain fk on
    the CPU."""
    t_len = qpos_traj.shape[0]
    kin = fk_batched(model, qpos_traj)
    zero_qvel = qpos_traj.new_zeros(t_len, model.ndof)
    zero_t = torch.zeros(t_len, dtype=torch.int64, device=qpos_traj.device)
    bquat = get_body_quat(tables, qpos_traj)
    feats = dict(
        obs=get_obs(p, qpos_traj, zero_qvel, zero_t),
        ee_pos=get_ee_pos(tables, kin, qpos_traj, p.obs_coord),
        ee_wpos=get_ee_pos(tables, kin, qpos_traj, None),
        bquat=bquat, com=engine.subtree_com(model, kin),
        head_pos=kin.xpos[:, tables.head_body],
        rq_rmh=M.de_heading(qpos_traj[:, 3:7]))
    # finite-difference velocities; frame 0 duplicates frame 1's value
    qvel = M.get_qvel_fd(qpos_traj[:-1], qpos_traj[1:], dt)
    qvel = torch.cat([qvel[:1], qvel], 0)
    rlinv_local = M.transform_vec(qvel[:, :3], qpos_traj[:, 3:7], p.obs_coord)
    bangvel = M.get_angvel_fd(bquat[:-1], bquat[1:], dt)
    bangvel = torch.cat([bangvel[:1], bangvel], 0)
    return dict(qpos=qpos_traj, qvel=qvel, rlinv=qvel[:, :3],
                rlinv_local=rlinv_local, rangv=qvel[:, 3:6], bangvel=bangvel,
                **feats, len=t_len)


def stack_experts(experts: Sequence[dict], device="cpu") -> ExpertBatch:
    """Pad (repeating the last frame) and stack per-take expert dicts."""
    tmax = max(int(e["len"]) for e in experts)

    def pad(key):
        outs = []
        for e in experts:
            a = e[key]
            a = a.detach().cpu().numpy() if torch.is_tensor(a) \
                else np.asarray(a)
            padded = np.zeros((tmax,) + a.shape[1:], a.dtype)
            padded[: a.shape[0]] = a
            padded[a.shape[0]:] = a[-1]
            outs.append(padded)
        return torch.as_tensor(np.stack(outs), device=device)

    qpos, head = pad("qpos"), pad("head_pos")
    lens = [int(e["len"]) for e in experts]
    return ExpertBatch(
        qpos=qpos, qvel=pad("qvel"), rlinv_local=pad("rlinv_local"),
        rangv=pad("rangv"), rq_rmh=pad("rq_rmh"), ee_pos=pad("ee_pos"),
        ee_wpos=pad("ee_wpos"), bquat=pad("bquat"), bangvel=pad("bangvel"),
        com=pad("com"), head_pos=head, obs=pad("obs"),
        lens=torch.as_tensor(lens, dtype=torch.int64, device=device),
        height_lb=torch.stack([qpos[i, :n, 2].min()
                               for i, n in enumerate(lens)]),
        head_height_lb=torch.stack([head[i, :n, 2].min()
                                    for i, n in enumerate(lens)]))


def synthetic_experts(model: PhysicsModel, p: EnvParams, tables: BodyTables,
                      spec: ModelSpec, n_takes: int = 2, t_len: int = 400,
                      seed: int = 0, dt: float = 1.0 / 30.0) -> ExpertBatch:
    """Synthetic mocap stand-in when the EgoPose dataset is absent: smooth
    sinusoidal joint motion on a standing root, drawn from the same numpy
    RandomState stream as the JAX package (bit-identical qpos)."""
    rng = np.random.RandomState(seed)
    experts = []
    for _ in range(n_takes):
        t = np.arange(t_len) * dt
        qpos = np.zeros((t_len, spec.nq))
        qpos[:, 2] = 0.92 + 0.02 * np.sin(2 * np.pi * 0.5 * t)
        qpos[:, 3] = 1.0
        lo = np.clip(spec.jnt_range[:, 0], -0.6, 0.0)
        hi = np.clip(spec.jnt_range[:, 1], 0.0, 0.6)
        amp = 0.25 * (hi - lo) * rng.uniform(0.2, 1.0, spec.nq - 7)
        center = 0.5 * (lo + hi)
        freq = rng.uniform(0.2, 0.7, spec.nq - 7)
        phase = rng.uniform(0, 2 * np.pi, spec.nq - 7)
        qpos[:, 7:] = center + amp * np.sin(2 * np.pi * freq * t[:, None]
                                            + phase)
        qpos = zero_hands(spec, qpos)
        q = torch.as_tensor(qpos).to(device=model.device, dtype=model.dtype)
        experts.append(gen_expert_features(model, p, tables, q, dt))
    return stack_experts(experts, device=model.device)
