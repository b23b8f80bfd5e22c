"""TRPO policy update (counterpart of egopose_tpu/rl/trpo.py).

A natural-gradient step: the surrogate's gradient, a conjugate-gradient
solve against the policy's Fisher matrix, and a backtracking line search
under a KL bound.  The Fisher product is the diagonal Gaussian's analytic
FIM (``use_fim``, the default: one jvp through the policy and one vjp
back) or the Hessian-vector product of the self-KL; for this policy family
the two are the same matrix.

Parameters are lists of tensors in the modules' ``parameters()`` order;
the flat vector of CG and the line search concatenates them in that order
(the JAX package flattens its trees in sorted-key order: the same step up
to roundoff).  CG runs a fixed number of iterations and the line search
evaluates every step, keeping the first accepted one with ``torch.where``,
so neither reads anything back to the host.

``mesh`` (parallel/mesh.py): data-parallel ranks, each holding its lanes.
The surrogate, its gradient, each Fisher product (damping added once),
the KL and the critic's loss and gradients are each rank's partial sums
over the global denominators, summed over the lanes' axis; CG and the
line search then run alike on every rank.  The context encodes of the
update stay whole on each rank of a ``time`` axis (torch.func's
transforms do not pass through the halo exchange's autograd Functions),
so the time ranks compute the update redundantly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
from torch import nn
from torch.func import functional_call, grad, grad_and_value, jvp, vjp

from ..ops.gae import estimate_advantages
from ..parallel import mesh as meshlib
from .distributions import diag_gaussian_log_prob


class TRPOHyper(NamedTuple):
    max_kl: float = 1e-2
    damping: float = 1e-2
    cg_iters: int = 10
    ls_steps: int = 10
    accept_ratio: float = 0.1
    use_fim: bool = True     # the analytic Gaussian FIM product; False: the
                             # Hessian-vector product of the self-KL


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    """Slices of ``flat`` shaped and typed as the tensors of ``like``."""
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return tuple(out)


def conjugate_gradient(avp: Callable, b: torch.Tensor,
                       iters: int) -> torch.Tensor:
    """CG solve of A x = b over exactly ``iters`` iterations (no early
    stop, as the JAX package's scan)."""
    x = torch.zeros_like(b)
    r = p = b
    rdotr = torch.dot(r, r)
    for _ in range(iters):
        ap = avp(p)
        alpha = rdotr / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        new_rdotr = torch.dot(r, r)
        p = r + (new_rdotr / rdotr) * p
        rdotr = new_rdotr
    return x


def gaussian_kl(mean0, log_std0, mean, log_std, w, n):
    """The exps-weighted mean KL(N(mean0, std0) || N(mean, std))."""
    kl = log_std - log_std0 + (torch.exp(2 * log_std0)
                               + (mean0 - mean) ** 2) \
        / (2 * torch.exp(2 * log_std)) - 0.5
    return torch.sum(kl.sum(-1) * w) / n


def _identity(x):
    return x


def fvp_fim(policy_in_fn: Callable, params, w, damping: float, n=None,
            gsum: Callable = _identity) -> Callable:
    """v -> F v + damping v, F the diagonal Gaussian's Fisher matrix at
    ``params`` with rows weighted by w / n (n = sum(w) unless given): the
    tangent of v through the policy (one jvp), scaled by the inverse
    variance for the mean and by 2 for the log-std, carried back (one
    vjp), then ``gsum`` (the sum over data-parallel ranks)."""
    params = tuple(params)
    if n is None:
        n = torch.clamp(w.sum(), min=1.0)
    (mean, log_std), vjp_fn = vjp(policy_in_fn, params)
    inv_var = torch.exp(-2.0 * log_std.detach())
    wn = (w / n).to(mean.dtype)

    def fvp(v):
        _, (dmean, dls) = jvp(policy_in_fn, (params,),
                              (_unflat(v, params),))
        cot_mean = dmean * inv_var * wn[..., None]
        # log_std broadcast to mean's shape (PolicyGaussian): per row
        cot_ls = 2.0 * dls * (wn[..., None] if dls.dim() == dmean.dim()
                              else wn.sum())
        (fv,) = vjp_fn((cot_mean, cot_ls.to(log_std.dtype)))
        return gsum(_flat(fv)) + damping * v
    return fvp


def fvp_direct(policy_in_fn: Callable, params, w, damping: float, n=None,
               gsum: Callable = _identity) -> Callable:
    """v -> H v + damping v, H the Hessian of the exps-weighted mean
    self-KL at ``params`` (forward over reverse); ``n`` and ``gsum`` as in
    fvp_fim."""
    params = tuple(params)
    if n is None:
        n = torch.clamp(w.sum(), min=1.0)

    def mean_kl(prm):
        mean, log_std = policy_in_fn(prm)
        return gaussian_kl(mean.detach(), log_std.detach(), mean, log_std,
                           w, n)

    def fvp(v):
        _, hvp = jvp(grad(mean_kl), (params,), (_unflat(v, params),))
        return gsum(_flat(hvp)) + damping * v
    return fvp


def trpo_step(params: Sequence[torch.Tensor], policy_in_fn: Callable, states,
              actions, advantages, exps, hyper: TRPOHyper = TRPOHyper(),
              gsum: Callable = _identity):
    """One TRPO policy update from ``params`` (left unchanged).

    ``policy_in_fn(params) -> (mean, log_std)`` over every recorded state
    (``states`` is the JAX signature's, read only through it).  Returns
    (new parameters, info): ``surrogate_loss`` before the step,
    ``ls_success``, ``surrogate_after`` and ``kl``, the true KL(old || new)
    over the batch, and ``step_frac``, the accepted step's fraction of the
    full step (0 when none was accepted).  ``gsum`` sums a tensor over the
    data-parallel ranks (module docstring)."""
    params = tuple(p.detach() for p in params)
    w = exps
    n = torch.clamp(gsum(w.sum()), min=1.0)
    with torch.no_grad():
        mean0, log_std0 = policy_in_fn(params)
        logp0 = diag_gaussian_log_prob(actions, mean0, log_std0)

    def partial_surrogate(prm):
        mean, log_std = policy_in_fn(prm)
        logp = diag_gaussian_log_prob(actions, mean, log_std)
        return -torch.sum(torch.exp(logp - logp0) * advantages * w) / n

    def surrogate(prm):
        return gsum(partial_surrogate(prm))

    g_tree, loss0 = grad_and_value(partial_surrogate)(params)
    g, loss0 = gsum(_flat(g_tree)), gsum(loss0)
    fvp = (fvp_fim if hyper.use_fim else fvp_direct)(
        policy_in_fn, params, w, hyper.damping, n, gsum)
    stepdir = conjugate_gradient(fvp, -g, hyper.cg_iters)
    shs = 0.5 * torch.dot(stepdir, fvp(stepdir))
    fullstep = stepdir / torch.sqrt(shs / hyper.max_kl)
    expected_improve = -torch.dot(g, fullstep)

    # backtracking line search: every step evaluated, the first accepted
    x0 = _flat(params)
    with torch.no_grad():
        best_x, done = x0, torch.zeros((), dtype=torch.bool,
                                       device=x0.device)
        step_frac = torch.zeros((), dtype=x0.dtype, device=x0.device)
        for i in range(hyper.ls_steps):
            frac = 0.5 ** i
            xnew = x0 + frac * fullstep
            actual = loss0 - surrogate(_unflat(xnew, params))
            expected = expected_improve * frac
            ok = (actual / torch.clamp(expected, min=1e-12)
                  > hyper.accept_ratio) & (actual > 0) & ~done
            best_x = torch.where(ok, xnew, best_x)
            step_frac = torch.where(ok, frac, step_frac)
            done = done | ok
        new_params = _unflat(best_x, params)
        mean, log_std = policy_in_fn(new_params)
        info = {"surrogate_loss": loss0.detach(), "ls_success": done,
                "surrogate_after": surrogate(new_params),
                "kl": gsum(gaussian_kl(mean0, log_std0, mean, log_std, w,
                                       n)),
                "step_frac": step_frac}
    return new_params, info


class _PolicyInput(nn.Module):
    """The policy on its context net's input, one module, so that one
    functional_call swaps the parameters of both (the policy's first)."""

    def __init__(self, policy: nn.Module, policy_vs: nn.Module):
        super().__init__()
        self.policy, self.policy_vs = policy, policy_vs

    def forward(self, windows, states):
        return self.policy(self.policy_vs.context(windows, states))


def trpo_update(ts, hyper, t_hyper: TRPOHyper, batch, windows, mesh=None):
    """TRPO on one sampled batch (time-major (T,B,...) tensors; windows the
    context nets' input), updating ``ts``'s nets in place.

    Values, advantages and returns come from the pre-update critic (GAE,
    normalized over valid steps), as in ppo_update.  The critic then fits
    ``hyper.num_epochs`` steps of the value optimizer on the MSE plus
    1e-3 * sum(p^2) over the value and value-context parameters; then one
    natural-gradient step moves the policy and policy-context parameters.
    The policy optimizer's state is left untouched.  ``mesh``: the batch
    is this rank's lanes (module docstring).  Returns (ts, metrics dict of
    0-d tensors)."""
    data = None if mesh is None else meshlib.Group(mesh, mesh.axis_names[0])
    gsum = _identity if data is None else data.sum
    # the critic's L2 term enters one rank's partial loss, so the sum over
    # the ranks holds it once
    l2_weight = 1e-3 if data is None or mesh.rank(data.axis) == 0 else 0.0
    valid = batch.valids
    n_valid = torch.clamp(gsum(valid.sum()), min=1.0)

    def values_of():
        return ts.value(ts.value_vs.context(windows, batch.states))

    with torch.no_grad():
        advantages, returns = estimate_advantages(
            batch.rewards, batch.masks, values_of(), hyper.gamma, hyper.tau,
            valid=valid, group=data)
    exp_w = batch.exps * valid

    vparams = ts.opt_value.params
    for _ in range(hyper.num_epochs):
        mse = torch.sum(((values_of() - returns) ** 2) * valid) / n_valid
        vloss = mse + l2_weight * sum(torch.sum(p ** 2) for p in vparams)
        ts.opt_value.step(meshlib.all_reduce_grads(
            mesh, torch.autograd.grad(vloss, vparams, allow_unused=True),
            vparams))

    module = _PolicyInput(ts.policy, ts.policy_vs)
    names = [name for name, _ in module.named_parameters()]

    def policy_in_fn(prm):
        return functional_call(module, dict(zip(names, prm)),
                               (windows, batch.states))

    pparams = ts.opt_policy.params
    new, info = trpo_step(pparams, policy_in_fn, batch.states, batch.actions,
                          advantages, exp_w, t_hyper, gsum)
    with torch.no_grad():
        for p, q in zip(pparams, new):
            p.copy_(q)
    metrics = {"policy_loss": info["surrogate_loss"],
               "value_loss": gsum(vloss.detach()), "kl": info["kl"],
               "surrogate_after": info["surrogate_after"],
               "ls_success": info["ls_success"].to(torch.float32),
               "n_valid": n_valid,
               "n_exp": torch.clamp(gsum(exp_w.sum()), min=1.0)}
    return ts, metrics


def update_value_lbfgs(value_loss_fn: Callable, params):
    """A critic fit by scipy's L-BFGS (maxiter 25) on the host:
    ``value_loss_fn(params) -> scalar`` and its gradient evaluated in the
    parameters' own dtype, float64 only at scipy's boundary.  Returns the
    fitted parameters (a tuple, each in its own dtype and device)."""
    from scipy.optimize import fmin_l_bfgs_b

    params = tuple(p.detach() for p in params)
    flat0 = _flat(params)
    grad_fn = grad_and_value(value_loss_fn)

    def f(x):
        g, v = grad_fn(_unflat(torch.as_tensor(x, device=flat0.device)
                               .to(flat0.dtype), params))
        return float(v), _flat(g).double().cpu().numpy()

    xf, _, _ = fmin_l_bfgs_b(f, flat0.double().cpu().numpy(),
                             maxiter=25)
    return _unflat(torch.as_tensor(xf, device=flat0.device), params)
