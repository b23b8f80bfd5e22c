"""PPO update (counterpart of egopose_tpu/rl/ppo.py).

Semantics, as in the JAX package:
- values, log-probs and GAE advantages from the pre-update parameters over
  the full batch;
- per epoch: a critic MSE step, then the clipped-surrogate policy step over
  exploration rows only (exps nonzero), with the log-ratio clamped to +-20;
- the policy optimizer covers the policy and its video-context net, with a
  global-norm clip at 40; the context nets are re-run inside each loss so
  their parameters receive gradients;
- each net's input is its context net's ``context(windows, states)``
  (the JAX package's ``*_ctx_apply``): per-step video context joined with
  the states for ego-mimic, the episode's past-video context joined with
  the state LSTM's unroll for ego-forecast;
- the optional ``kl_target`` stop (Schulman's KL3 estimate against the
  sampling policy, decided before each policy step): once it trips, the
  remaining policy steps change neither the parameters nor the optimizer
  state, while the critic keeps fitting;
- the optional lane-grained minibatch path: each epoch permutes the lanes
  and takes one critic + policy step per ``mini_batch_lanes`` slice;
- ``objective="a2c"``: the vanilla policy-gradient loss
  -sum(log_prob * advantage) over exploration rows in place of the clipped
  surrogate, with the same epoch, critic and ``kl_target`` loop;
- ``mesh`` (parallel/mesh.py): data-parallel ranks, each holding its
  lanes.  GAE stays per lane, its normalization over every rank's lanes;
  the denominators, the KL estimate and the reported losses are summed
  over the ranks, each loss is the rank's partial sum over the global
  denominator, and the gradients are summed before each optimizer step,
  so the clip and the non-finite skip see the global gradient on every
  rank.  The minibatch path draws the global
  permutation on every rank and takes the entries in its lanes; a rank
  with none still joins every sum, with zero gradients.  With a ``time``
  axis the ego-mimic context encodes run time-sharded
  (parallel/seqpar.py): the loss after the encode runs alike on each time
  rank, so the context nets' gradients are summed over both axes and the
  others over the lanes' axis only.

``Adam`` reproduces the JAX package's optax chain exactly (see its
docstring), including optax's clip formula and ``apply_if_finite``; its
steps read nothing back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..ops.gae import estimate_advantages
from ..parallel import mesh as meshlib
from ..parallel import seqpar
from .distributions import diag_gaussian_log_prob
from .rollout import SegmentBatch


class PPOHyper(NamedTuple):
    gamma: float = 0.95
    tau: float = 0.95
    clip_epsilon: float = 0.2
    num_epochs: int = 10
    value_opt_niter: int = 1
    kl_target: float = 0.0   # > 0: stop the policy steps once the approximate
                             # KL to the sampling policy exceeds it (config key
                             # policy_kl_target); 0 disables


class Adam:
    """``optax.inject_hyperparams(optax.apply_if_finite(optax.chain(
    [clip_by_global_norm(grad_clip)], adam | adamw), 100))`` over a list of
    parameters, updated in place:

    - the gradient is checked first: a non-finite one leaves parameters and
      moments unchanged and counts in ``notfinite_count`` (consecutive) and
      ``total_notfinite``; after more than MAX_CONSECUTIVE_ERRORS in a row
      the update is applied anyway, so a broken run surfaces;
    - clip (optax's formula): g -> (g / norm) * grad_clip unless
      norm < grad_clip, norm the global L2 norm;
    - Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments), plus
      weight_decay * p (AdamW) when it is nonzero;
    - p <- p - lr * update, ``lr`` settable between steps.

    A missing gradient counts as zeros (optax sees a zero gradient for a
    stop_gradient parameter)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8
    MAX_CONSECUTIVE_ERRORS = 100

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 grad_clip: float = 0.0, weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.grad_clip, self.weight_decay = lr, grad_clip, \
            weight_decay
        dev = self.params[0].device
        zero = lambda: torch.zeros((), dtype=torch.int64, device=dev)
        self.count, self.notfinite_count, self.total_notfinite = \
            zero(), zero(), zero()
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads, skip: torch.Tensor | None = None):
        """One update from ``grads`` (one per parameter, None = zeros).
        ``skip`` (a 0-d bool tensor) true leaves parameters and every part
        of the state unchanged."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        isfinite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        notfinite = torch.where(isfinite, torch.zeros_like(self.count),
                                self.notfinite_count + 1)
        accept = isfinite | (notfinite > self.MAX_CONSECUTIVE_ERRORS)
        keep_state = torch.zeros_like(isfinite) if skip is None else skip
        commit = accept & ~keep_state
        if self.grad_clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            grads = [torch.where(norm < self.grad_clip, g,
                                 (g / norm) * self.grad_clip) for g in grads]
        count = self.count + 1
        f64 = lambda x: torch.tensor(x, dtype=torch.float64,
                                     device=count.device)
        bc1 = 1 - f64(self.B1) ** count
        bc2 = 1 - f64(self.B2) ** count
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu = (1 - self.B1) * g + self.B1 * self.mu[i]
            nu = (1 - self.B2) * g ** 2 + self.B2 * self.nu[i]
            u = (mu / bc1.to(p.dtype)) / (torch.sqrt(nu / bc2.to(p.dtype))
                                          + self.EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.copy_(torch.where(commit, p + (-self.lr) * u, p))
            self.mu[i] = torch.where(commit, mu, self.mu[i])
            self.nu[i] = torch.where(commit, nu, self.nu[i])
        self.count = torch.where(commit, count, self.count)
        self.notfinite_count = torch.where(keep_state, self.notfinite_count,
                                           notfinite)
        self.total_notfinite = torch.where(
            keep_state | isfinite, self.total_notfinite,
            self.total_notfinite + 1)

    def state_dict(self) -> dict:
        """The optimizer's whole state (optax's moments, step count and
        skip counters, and the injected learning rate), as CPU tensors."""
        t = lambda x: x.detach().cpu().clone()
        return {"mu": [t(m) for m in self.mu], "nu": [t(v) for v in self.nu],
                "count": t(self.count),
                "notfinite_count": t(self.notfinite_count),
                "total_notfinite": t(self.total_notfinite),
                "lr": float(self.lr)}

    def load_state_dict(self, state: dict):
        """Restore what ``state_dict`` returned, each tensor on its
        parameter's device and in the dtype it was saved in."""
        dev = self.params[0].device
        self.mu = [t.to(dev) for t in state["mu"]]
        self.nu = [t.to(dev) for t in state["nu"]]
        for k in ("count", "notfinite_count", "total_notfinite"):
            setattr(self, k, state[k].to(dev))
        self.lr = float(state["lr"])


class TrainState(NamedTuple):
    """The four nets (updated in place) and the two optimizers."""
    policy: nn.Module
    policy_vs: nn.Module
    value: nn.Module
    value_vs: nn.Module
    opt_policy: Adam
    opt_value: Adam


def make_optimizers(policy_params, value_params, policy_lr, value_lr,
                    grad_clip=40.0, policy_weight_decay=0.0,
                    value_weight_decay=0.0):
    """(policy optimizer over the policy and policy-context parameters,
    with the global-norm clip; value optimizer over the value and
    value-context parameters, without), both skipping non-finite updates
    up to 100 in a row."""
    return (Adam(policy_params, policy_lr, grad_clip=grad_clip,
                 weight_decay=policy_weight_decay),
            Adam(value_params, value_lr, weight_decay=value_weight_decay))


def local_lanes(mesh, idx: torch.Tensor, n_local: int, segments: int = 1):
    """The entries of global lane indices ``idx`` that this rank holds, as
    its local indices, in ``idx``'s order.  A batch of ``segments``
    segments lists each segment's lanes in turn; a rank holds the same
    contiguous slice of every segment."""
    if mesh is None:
        return idx
    k = n_local // segments                    # a rank's lanes a segment
    b = k * mesh.size(mesh.axis_names[0])      # all lanes a segment
    seg, lane = idx // b, idx % b
    mine = lane // k == mesh.rank(mesh.axis_names[0])
    return (seg * k + lane % k)[mine]


def ppo_update(ts: TrainState, hyper: PPOHyper, batch: SegmentBatch,
               windows: torch.Tensor, mini_batch_lanes: int = 0, perms=None,
               generator: torch.Generator | None = None,
               objective: str = "ppo", mesh=None, segments: int = 1):
    """Run ``hyper.num_epochs`` PPO epochs on one sampled batch (time-major
    (T,B,...) tensors; windows (B,W,feat), the input of the context nets'
    ``context``), updating ``ts``'s nets and optimizers in place.

    ``mini_batch_lanes`` in (0, B): the minibatch path; ``perms`` (epochs,
    n_mb * mini_batch_lanes) gives each epoch's lane order, else it is drawn
    from ``generator``.  ``objective`` "ppo" (the clipped surrogate) or
    "a2c" (the vanilla policy gradient).  ``mesh``: data-parallel ranks
    (module docstring), the batch being this rank's lanes of ``segments``
    segments.  Returns (ts, metrics dict of 0-d tensors)."""
    if objective not in ("ppo", "a2c"):
        raise ValueError(f"objective must be ppo|a2c, got {objective!r}")
    bsz = batch.rewards.shape[1]
    valid = batch.valids
    data = None if mesh is None else meshlib.Group(mesh, mesh.axis_names[0])
    gsum = (lambda x: x) if data is None else data.sum
    time_axis = mesh.axis_names[1] if mesh is not None \
        and len(mesh.axis_names) > 1 else None
    sp = time_axis is not None and mesh.size(time_axis) > 1
    wide = {id(p) for net in (ts.policy_vs, ts.value_vs)
            for p in net.parameters()} if sp else set()

    def context(vs_net, win, states):
        if not sp:
            return vs_net.context(win, states)
        v_ctx = seqpar.vsnet_encode_sp(mesh, vs_net, win, axis=time_axis)
        return torch.cat([v_ctx.transpose(0, 1), states], -1)

    def policy_logprob(states, win, actions):
        mean, log_std = ts.policy(context(ts.policy_vs, win, states))
        return diag_gaussian_log_prob(actions, mean, log_std)

    def values_of(states, win):
        return ts.value(context(ts.value_vs, win, states))

    with torch.no_grad():
        fixed_log_probs = policy_logprob(batch.states, windows,
                                         batch.actions)
        values = values_of(batch.states, windows)
        advantages, returns = estimate_advantages(
            batch.rewards, batch.masks, values, hyper.gamma, hyper.tau,
            valid=valid, group=data)
    exp_w = batch.exps * valid
    stop = torch.zeros((), dtype=torch.bool, device=valid.device)

    def opt_step(d):
        nonlocal stop
        states, actions, win, flp, adv, ret, val, expw = d
        nv, ne = torch.clamp(gsum(torch.stack([val.sum(), expw.sum()])),
                             min=1.0)
        for _ in range(hyper.value_opt_niter):
            vloss = torch.sum(((values_of(states, win) - ret) ** 2) * val) / nv
            params = ts.opt_value.params
            ts.opt_value.step(meshlib.all_reduce_grads(
                mesh, torch.autograd.grad(vloss, params, allow_unused=True),
                params, wide))
        if hyper.kl_target > 0:
            with torch.no_grad():
                lr = torch.clamp(policy_logprob(states, win, actions) - flp,
                                 -20.0, 20.0)
                approx_kl = gsum(torch.sum(((torch.exp(lr) - 1.0) - lr)
                                           * expw)) / ne
            stop = stop | (approx_kl > hyper.kl_target)
        log_probs = policy_logprob(states, win, actions)
        if objective == "a2c":
            ploss = -torch.sum(log_probs * adv * expw) / ne
        else:
            ratio = torch.exp(torch.clamp(log_probs - flp, -20.0, 20.0))
            surr1 = ratio * adv
            surr2 = torch.clamp(ratio, 1.0 - hyper.clip_epsilon,
                                1.0 + hyper.clip_epsilon) * adv
            ploss = -torch.sum(torch.minimum(surr1, surr2) * expw) / ne
        params = ts.opt_policy.params
        ts.opt_policy.step(
            meshlib.all_reduce_grads(
                mesh, torch.autograd.grad(ploss, params, allow_unused=True),
                params, wide),
            skip=stop if hyper.kl_target > 0 else None)
        return ploss.detach(), vloss.detach()

    full = (batch.states, batch.actions, windows, fixed_log_probs,
            advantages, returns, valid, exp_w)
    n_all = bsz if mesh is None else bsz * mesh.size(mesh.axis_names[0])
    if mini_batch_lanes and mini_batch_lanes < n_all:
        mb = int(mini_batch_lanes)
        n_mb = n_all // mb
        if perms is None:
            perms = torch.stack([
                torch.randperm(n_all, generator=generator,
                               device=generator.device)[:n_mb * mb]
                for _ in range(hyper.num_epochs)])
        for perm in torch.as_tensor(perms, device=valid.device):
            for idx in perm.reshape(n_mb, mb):
                idx = local_lanes(mesh, idx, bsz, segments)
                states, actions, win, flp, adv, ret, val, expw = full
                losses = opt_step((states[:, idx], actions[:, idx], win[idx],
                                   flp[:, idx], adv[:, idx], ret[:, idx],
                                   val[:, idx], expw[:, idx]))
    else:
        for _ in range(hyper.num_epochs):
            losses = opt_step(full)
    ploss, vloss, n_valid, n_exp = gsum(torch.stack(
        [*losses, valid.sum(), exp_w.sum()]))
    metrics = {"policy_loss": ploss, "value_loss": vloss,
               "n_valid": torch.clamp(n_valid, min=1.0),
               "n_exp": torch.clamp(n_exp, min=1.0)}
    if hyper.kl_target > 0:
        metrics["kl_stopped"] = stop
    return ts, metrics
