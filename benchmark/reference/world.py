"""The reference's world, nets and update, built from the benchmark's own
inputs (the configuration, the seed, the committed checkpoint file) with
the frozen plain modules under ``plain/``.  Nothing here reads what the
program made: the synthetic experts, the CNN features, the model tables
and the initial weights are all worked out again.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .plain import envs as E
from .plain.convert import load_checkpoint_pickle, params_from_jax
from .plain.models.video_forecast_net import VideoForecastNet
from .plain.models.video_state_net import VideoStateNet
from .plain.ops import math_utils as M
from .plain.ops import quat as Q
from .plain.ops import running_norm
from .plain.ops.gae import estimate_advantages
from .plain.physics.model import build_model
from .plain.physics.spec import parse_mjcf
from .plain.rl.distributions import diag_gaussian_log_prob
from .plain.rl.nets import PolicyGaussian, Value
from .plain.utils.config import (EgoForecastConfig, EgoMimicConfig,
                                 make_env_params)

XML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "humanoid_1205_v1.xml")


class World(NamedTuple):
    cfg: object
    spec: object
    model: object
    tables: object
    p: object
    expert: object
    cnn_feat: torch.Tensor     # (E, T, 64)


def make_cfg(kind: str, cfg_dict: dict):
    cls = EgoForecastConfig if kind == "egoforecast" else EgoMimicConfig
    return cls("bench", cfg_dict=cfg_dict, base_dir="_none",
               data_dir="_none")


def build_world(cfg, n_takes: int, t_len: int, dtype, device) -> World:
    """The synthetic world of ``--synthetic``: experts replayed from the
    seed's sinusoidal motion and the seed's projected "CNN features",
    drawn from np.random.RandomState(cfg.seed) as the program's contract
    states (its ``build_world``)."""
    spec = parse_mjcf(XML)
    model = build_model(spec, dtype=dtype, device=device)
    tables = E.make_body_tables(spec, device)
    obs_dim = (1 if cfg.obs_heading else 0) + (spec.nq - 2) \
        + {"root": 6, "full": spec.ndof}.get(cfg.obs_vel, 0) \
        + (1 if cfg.obs_phase else 0)
    p = make_env_params(cfg, spec, obs_dim=obs_dim, dtype=dtype,
                        device=device)
    expert = E.synthetic_experts(model, p, tables, spec, n_takes=n_takes,
                                 t_len=t_len, seed=cfg.seed)
    rng = np.random.RandomState(cfg.seed)
    proj = rng.randn(expert.obs.shape[-1], 64).astype(np.float32) / 8
    obs = expert.obs.detach().cpu().numpy().astype(np.float32)
    feat = np.einsum("etf,fc->etc", obs, proj)
    feat += 0.1 * rng.randn(*feat.shape).astype(np.float32)
    return World(cfg, spec, model, tables, p, expert,
                 torch.as_tensor(feat).to(device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------

class Nets(NamedTuple):
    policy: torch.nn.Module
    policy_vs: torch.nn.Module
    value: torch.nn.Module
    value_vs: torch.nn.Module


def make_nets(kind: str, cfg, obs_dim: int, nu: int, seed: int, dtype,
              device) -> Nets:
    """Fresh nets as the configuration's agent makes them: under
    torch.manual_seed(seed) on the CPU, in the order policy, value, policy
    context, value context, in float32, then cast."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if kind == "egoforecast":
            pvs, vvs = (VideoForecastNet(
                64, obs_dim, getattr(cfg, f"{w}_v_hdim"), cfg.fr_margin,
                getattr(cfg, f"{w}_v_net"), getattr(cfg, f"{w}_s_hdim"),
                getattr(cfg, f"{w}_s_net"), getattr(cfg, f"{w}_dyn_v"),
                getattr(cfg, f"{w}_v_net_param")) for w in ("policy", "value"))
            pol = PolicyGaussian(pvs.out_dim, nu, cfg.policy_hsize,
                                 cfg.policy_htype, cfg.log_std, cfg.fix_std)
            val = Value(vvs.out_dim, cfg.value_hsize, cfg.value_htype)
        else:
            pol = PolicyGaussian(obs_dim + cfg.policy_v_hdim, nu,
                                 cfg.policy_hsize, cfg.policy_htype,
                                 cfg.log_std, cfg.fix_std)
            val = Value(obs_dim + cfg.value_v_hdim, cfg.value_hsize,
                        cfg.value_htype)
            pvs, vvs = (VideoStateNet(64, getattr(cfg, f"{w}_v_hdim"),
                                      cfg.fr_margin, getattr(cfg, f"{w}_v_net"),
                                      cfg.causal,
                                      getattr(cfg, f"{w}_v_net_param"))
                        for w in ("policy", "value"))
    nets = Nets(pol, pvs, val, vvs)
    for n in nets:
        n.to(device=device, dtype=dtype).eval()
    return nets


def load_mimic_checkpoint(nets: Nets, path: str, dtype, device):
    """All four nets and the filter from an ego-mimic checkpoint pickle;
    returns the filter's statistics in ``dtype``."""
    cp = load_checkpoint_pickle(path)
    keys = ("policy_dict", "policy_vs_dict", "value_dict", "value_vs_dict")
    for net, sd in zip(nets, params_from_jax(*[cp[k] for k in keys])):
        net.load_state_dict({k: v.to(dtype) for k, v in sd.items()})
    st = cp["running_state"]
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(
        device=device, dtype=dtype)
    return running_norm.RunningStat(as_t(st.n), as_t(st.mean), as_t(st.s))


def warm_start(nets: Nets, path: str):
    """Copy the ego-mimic checkpoint's policy and value weights wherever the
    parameter exists with the same shape (the forecast agent's warm
    start)."""
    cp = load_checkpoint_pickle(path)
    sd_p, _, sd_v, _ = params_from_jax(cp["policy_dict"], {"params": {}},
                                       cp["value_dict"], {"params": {}})
    for net, src in ((nets.policy, sd_p), (nets.value, sd_v)):
        dst = net.state_dict()
        dst.update({k: v.to(dtype=dst[k].dtype, device=dst[k].device)
                    for k, v in src.items()
                    if k in dst and dst[k].shape == v.shape})
        net.load_state_dict(dst)


def leaves(nets: Nets) -> dict:
    """name -> parameter, over the four nets, in a fixed order."""
    out = {}
    for tag, net in zip(("policy", "policy_vs", "value", "value_vs"), nets):
        for k, v in net.named_parameters():
            out[f"{tag}.{k}"] = v
    return out


# ---------------------------------------------------------------------------
# the eval's fail-safe (the product CLI's semantics)
# ---------------------------------------------------------------------------

def kinematic_state_pred(expert, take: int):
    """The ground-truth kinematic state in the statereg layout (de-headed
    qpos[2:] ++ heading-frame finite-difference qvel), (T, nq-2+nv)."""
    qpos = expert.qpos[take]
    qvel = M.get_qvel_fd(qpos[:-1], qpos[1:], 1 / 30.0, "heading")
    qvel = torch.cat([qvel, qvel[-1:]], 0)
    pos = torch.cat([qpos[:, 2:3], M.de_heading(qpos[:, 3:7]), qpos[:, 7:]],
                    1)
    return torch.cat([pos, qvel], 1)


def reset_to_pred(p, tables, qpos_ref, pred_row):
    """(qpos, qvel) re-anchored to the predicted states (B, nq-2+nv),
    aligned to ``qpos_ref``'s xy and heading."""
    nq = p.nq
    qpos = torch.cat([qpos_ref[:, :2], pred_row[:, :nq - 2]], 1)
    qvel = pred_row[:, nq - 2:].clone()
    hq = M.get_heading_q(qpos_ref[:, 3:7])
    qpos[:, 3:7] = Q.quat_mul(hq, qpos[:, 3:7])
    qvel[:, :3] = Q.quat_rotate(hq, qvel[:, :3])
    return qpos, qvel


# ---------------------------------------------------------------------------
# the rollout's random numbers (drawn as the configuration's sampler draws
# them: one generator on the device, seeded with the seed)
# ---------------------------------------------------------------------------

class Noise(NamedTuple):
    expert_ind: torch.Tensor
    start_ind: torch.Tensor
    cur_t0: torch.Tensor
    init_noise: torch.Tensor
    gate: torch.Tensor
    act_noise: torch.Tensor
    anchor_noise: torch.Tensor


def draw_noise(p, expert_lens, n_expert: int, lanes: int, noise_rate: float,
               gen: torch.Generator, dtype) -> Noise:
    """One segment's draws: reset take, start frame, cur_t (0), joint noise,
    the exploration gates, action noise and re-anchor noise."""
    dev = gen.device
    draw = lambda lo, hi: torch.floor(
        lo + (hi - lo) * torch.rand(lanes, generator=gen, device=dev,
                                    dtype=torch.float64)).to(torch.int64)
    expert_ind = draw(0, n_expert)
    if p.env_start_first:
        start_ind = torch.zeros(lanes, dtype=torch.int64, device=dev)
    else:
        hi = expert_lens.to(dev)[expert_ind] - p.env_episode_len \
            - p.fr_margin
        hi = torch.clamp(hi, min=p.fr_margin + 1)
        start_ind = draw(p.fr_margin, hi.to(torch.float64))
    cur_t0 = draw(0, p.env_episode_len) if p.random_cur_t else \
        torch.zeros(lanes, dtype=torch.int64, device=dev)
    init_noise = torch.randn(lanes, p.nq - 7, generator=gen, device=dev,
                             dtype=dtype)
    t_len = p.env_episode_len
    gate = torch.rand(t_len, lanes, generator=gen, device=dev,
                      dtype=dtype) < noise_rate
    act = torch.randn(t_len, lanes, p.nu, generator=gen, device=dev,
                      dtype=dtype)
    anchor = torch.randn(t_len, lanes, p.nq - 7, generator=gen, device=dev,
                         dtype=dtype)
    return Noise(expert_ind, start_ind, cur_t0, init_noise, gate, act, anchor)


def windows_of(kind: str, cnn_feat, expert_ind, start_ind, margin: int,
               ep_len: int):
    """Each lane's CNN-feature window: ego-mimic [start - margin, start +
    ep_len + margin), ego-forecast the past [start - margin, start)."""
    width = margin if kind == "egoforecast" else ep_len + 2 * margin
    t_max = cnn_feat.shape[1]
    start = start_ind - margin
    start = torch.clamp(torch.where(start < 0, start + t_max, start), 0,
                        t_max - width)
    idx = start[:, None] + torch.arange(width, device=cnn_feat.device)
    return cnn_feat[expert_ind[:, None], idx]


# ---------------------------------------------------------------------------
# the PPO update (the configuration's objective: full-batch epochs, a critic
# step then a clipped-surrogate policy step, Adam with optax's semantics)
# ---------------------------------------------------------------------------

class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) after an optional
    clip of the global gradient norm (optax's formula), skipping a step
    whose gradient is not finite.  ``first_grad`` keeps the gradient of
    the first step as the optimizer gets it (after the clip)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, lr, grad_clip=0.0):
        self.params, self.lr, self.grad_clip = list(params), lr, grad_clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.first_grad = None

    @torch.no_grad()
    def step(self, grads):
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            return
        if self.grad_clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if not bool(norm < self.grad_clip):
                grads = [(g / norm) * self.grad_clip for g in grads]
        if self.first_grad is None:
            self.first_grad = [g.clone() for g in grads]
        self.count += 1
        bc1 = 1 - self.B1 ** self.count
        bc2 = 1 - self.B2 ** self.count
        for i, (p, g) in enumerate(zip(self.params, grads)):
            self.mu[i] = (1 - self.B1) * g + self.B1 * self.mu[i]
            self.nu[i] = (1 - self.B2) * g ** 2 + self.B2 * self.nu[i]
            u = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + self.EPS)
            p.add_(-self.lr * u)


def make_adams(nets: Nets, cfg):
    return (Adam([*nets.policy.parameters(), *nets.policy_vs.parameters()],
                 cfg.policy_lr, grad_clip=40.0),
            Adam([*nets.value.parameters(), *nets.value_vs.parameters()],
                 cfg.value_lr))


def ppo_update(nets: Nets, opts, cfg, batch: dict, windows):
    """One update on a sampled batch (time-major (T, B, ...) tensors):
    values, log-probs and GAE from the pre-update nets, then
    ``num_optim_epoch`` epochs of a critic step and a policy step over the
    exploration rows.  Returns the last epoch's (policy loss, value
    loss)."""
    states, actions = batch["states"], batch["actions"]
    valid, exp_w = batch["valids"], batch["exps"] * batch["valids"]

    def logprob(win):
        mean, log_std = nets.policy(nets.policy_vs.context(win, states))
        return diag_gaussian_log_prob(actions, mean, log_std)

    values_of = lambda win: nets.value(nets.value_vs.context(win, states))
    with torch.no_grad():
        fixed = logprob(windows)
        adv, ret = estimate_advantages(batch["rewards"], batch["masks"],
                                       values_of(windows), cfg.gamma,
                                       cfg.tau, valid=valid)
    nv = torch.clamp(valid.sum(), min=1.0)
    ne = torch.clamp(exp_w.sum(), min=1.0)
    opt_p, opt_v = opts
    for _ in range(cfg.num_optim_epoch):
        vloss = torch.sum(((values_of(windows) - ret) ** 2) * valid) / nv
        opt_v.step(torch.autograd.grad(vloss, opt_v.params,
                                       allow_unused=True))
        ratio = torch.exp(torch.clamp(logprob(windows) - fixed, -20.0, 20.0))
        surr = torch.minimum(ratio * adv, torch.clamp(
            ratio, 1.0 - cfg.clip_epsilon, 1.0 + cfg.clip_epsilon) * adv)
        ploss = -torch.sum(surr * exp_w) / ne
        opt_p.step(torch.autograd.grad(ploss, opt_p.params,
                                       allow_unused=True))
    return float(ploss.detach()), float(vloss.detach())


def fill_log_std(nets: Nets, value: float):
    with torch.no_grad():
        nets.policy.action_log_std.fill_(float(value))
