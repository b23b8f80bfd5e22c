"""Video-conditioned GAIL (counterpart of egopose_tpu/rl/vgail.py).

An adversarial discriminator (an MLP over video-context-conditioned
states, with its own context net) beside the ego agent: its BCE update
labels generator states 1 and expert observations 0, the expert states
drawn from the same (expert_ind, start_ind) windows as the sampled
episodes, and its -log D(s) reward replaces (or is blended with) the
imitation reward before the policy update.  No shipped config uses it.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.mlp import MLP
from ..models.video_state_net import VideoStateNet
from ..ops import running_norm
from ..parallel import mesh as meshlib
from . import ppo, rollout
from .agent_ego import AgentEgo


class Discriminator(nn.Module):
    """MLP ``net`` -> one logit (``head``)."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (128, 128),
                 activation: str = "relu"):
        super().__init__()
        self.net = MLP(input_dim, hidden_dims, activation)
        self.head = nn.Linear(self.net.out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.net(x))[..., 0]


def make_discriminator(in_dim: int, vs_net: nn.Module,
                       hidden_dims: Sequence[int] = (128, 128),
                       lr: float = 1e-4, dtype=torch.float32, device="cpu"):
    """(Discriminator, its optimizer) on ``device`` in ``dtype``, ``vs_net``
    moved there too.  The optimizer covers both nets: the port's Adam with
    the global-norm clip at 40, which is the JAX package's
    ``optax.chain(clip_by_global_norm(40), adam(lr))`` while the gradients
    are finite (the port's Adam also skips a non-finite update, as
    ``apply_if_finite`` does; the JAX chain has no such guard)."""
    disc = Discriminator(in_dim, hidden_dims)
    for net in (disc, vs_net):
        net.to(device=device, dtype=dtype).eval()
    opt = ppo.Adam([*disc.parameters(), *vs_net.parameters()], lr,
                   grad_clip=40.0)
    return disc, opt


def gail_reward(disc: Discriminator, disc_vs: nn.Module,
                windows: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
    """-log D(s) of each generator state (T, B)."""
    with torch.no_grad():
        return -F.logsigmoid(disc(disc_vs.context(windows, states)))


def update_discriminator(disc: Discriminator, disc_vs: nn.Module,
                         opt: ppo.Adam, windows, gen_states, expert_obs,
                         zstat: running_norm.RunningStat,
                         num_update: int = 10, mesh=None) -> torch.Tensor:
    """``num_update`` BCE steps: generator states labelled 1, expert
    observations 0, the expert observations normalized with the sampler's
    statistics (unclipped).  ``mesh``: the states are this rank's lanes;
    each mean is over every rank's and the gradients are summed over the
    lanes' axis.  Returns the loss before the last step."""
    e_states = running_norm.apply(zstat, expert_obs, clip=None)
    loss = torch.zeros((), dtype=gen_states.dtype, device=gen_states.device)
    if mesh is None:
        mean = torch.mean
    else:
        axis = mesh.axis_names[0]
        n = meshlib.all_reduce_sum(mesh, torch.tensor(
            float(gen_states.shape[0] * gen_states.shape[1]),
            dtype=gen_states.dtype, device=gen_states.device), axis)
        mean = lambda x: x.sum() / n
    for _ in range(num_update):
        v_ctx = disc_vs(windows).transpose(0, 1)
        g_o = disc(torch.cat([v_ctx, gen_states], -1))
        e_o = disc(torch.cat([v_ctx, e_states], -1))
        loss = -mean(F.logsigmoid(g_o)) - mean(F.logsigmoid(-e_o))
        opt.step(meshlib.all_reduce_grads(mesh, torch.autograd.grad(
            loss, opt.params, allow_unused=True), opt.params))
        loss = loss.detach()
    if mesh is not None:
        loss = meshlib.all_reduce_sum(mesh, loss, axis)
    return loss


def gather_expert_obs(expert, expert_ind: torch.Tensor,
                      start_ind: torch.Tensor, t_len: int) -> torch.Tensor:
    """The expert observations of the sampled episodes' frames (T, B, obs),
    sliced as jax.lax.dynamic_slice_in_dim slices."""
    return rollout.slice_windows(expert.obs, expert_ind, start_ind,
                                 t_len).transpose(0, 1)


class AgentVGAIL(AgentEgo):
    """AgentEgo with the adversarial discriminator, chosen by a
    ``discriminator:`` config block {hidden_dims, lr, num_update,
    reward_weight}.  Before each policy update the batch's rewards become
    ``w * (-log D(s)) + (1 - w) * r`` (``reward_weight`` w in (0, 1], 1 the
    pure GAIL reward); the discriminator updates after the policy.  Its
    weights are not in either checkpoint format, as in the JAX package."""

    def __init__(self, model, spec, params, tables, expert, cnn_feat, cfg,
                 batch_lanes: int = 1024, seed: int = 1,
                 dtype=torch.float32, device="cpu", mesh=None):
        dcfg = dict(getattr(cfg, "discriminator", None) or {})
        self.reward_weight = float(dcfg.get("reward_weight", 1.0))
        if not 0.0 < self.reward_weight <= 1.0:
            raise ValueError("discriminator.reward_weight must be in (0,1]")
        self.discrim_num_update = int(dcfg.get("num_update", 10))
        super().__init__(model, spec, params, tables, expert, cnn_feat, cfg,
                         batch_lanes=batch_lanes, seed=seed, dtype=dtype,
                         device=device, mesh=mesh)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + 29)
            # its own context net, of the policy's architecture
            self.discrim_vs_net = VideoStateNet(
                self.cnn_feat.shape[-1], cfg.policy_v_hdim, cfg.fr_margin,
                cfg.policy_v_net, cfg.causal, cfg.policy_v_net_param)
            self.discrim_net, self.discrim_opt = make_discriminator(
                params.obs_dim + cfg.policy_v_hdim, self.discrim_vs_net,
                tuple(dcfg.get("hidden_dims", (128, 128))),
                float(dcfg.get("lr", 1e-4)), dtype, self.device)
        if mesh is not None:
            meshlib.replicate(mesh, [self.discrim_net, self.discrim_vs_net])

    def update_params(self, batch) -> dict:
        windows = self._windows(batch)
        g_r = gail_reward(self.discrim_net, self.discrim_vs_net, windows,
                          batch.states)
        w = self.reward_weight
        shaped = batch._replace(rewards=(w * g_r + (1.0 - w) * batch.rewards)
                                .to(batch.rewards.dtype))
        metrics = self._update(shaped, windows)
        expert_obs = gather_expert_obs(self.expert, batch.expert_ind,
                                       batch.start_ind,
                                       self.p.env_episode_len)
        metrics["discrim_loss"] = update_discriminator(
            self.discrim_net, self.discrim_vs_net, self.discrim_opt, windows,
            batch.states, expert_obs, self.zstat, self.discrim_num_update,
            self.mesh)
        return self._host_metrics(metrics)
