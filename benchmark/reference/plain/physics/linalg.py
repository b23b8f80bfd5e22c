"""Dense SPD solve and the contact sweeps, plain PyTorch (frozen copy of
the plain functions of egopose_tpu_torch/physics/linalg.py)."""
from __future__ import annotations


import torch


def spd_solve_plain(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched dense SPD solve A X = rhs, (B,n,n), (B,n,r) -> (B,n,r).
    A system whose factorization fails (not positive definite, or not
    finite) gets a NaN answer: the reference has none to give for it."""
    factor, info = torch.linalg.cholesky_ex(a)
    out = torch.cholesky_solve(rhs, factor)
    return torch.where((info != 0)[:, None, None], torch.nan, out)


def contact_sweep_blocks(jf, w, target, mu, v_pred, iters, relax):
    """Projected-Jacobi sweep in block row order given the Delassus columns
    W = Minv J^T (B,nd,c): friction box on the first 3K rows, lambda >= 0 on
    the trailing frictionless pair rows.  Returns the post-contact
    velocity."""
    k = mu.shape[-1]
    c = jf.shape[1]
    a = jf @ w                                          # (B,c,c)
    bhat = (jf @ v_pred[..., None])[..., 0] - target
    # Gershgorin (row-sum) preconditioner keeps the sweep a contraction
    diag = torch.sum(torch.abs(a), -1) + 1.0e-9
    lam = v_pred.new_zeros(v_pred.shape[0], c)
    for _ in range(iters):
        g = (a @ lam[..., None])[..., 0] + bhat
        lam = lam - relax * g / diag
        ln = torch.clamp(lam[:, 2 * k:3 * k], min=0.0)
        lim = mu * ln
        parts = [torch.clamp(lam[:, :k], -lim, lim),
                 torch.clamp(lam[:, k:2 * k], -lim, lim), ln]
        if c > 3 * k:
            parts.append(torch.clamp(lam[:, 3 * k:], min=0.0))
        lam = torch.cat(parts, 1)
    return v_pred + (w @ lam[..., None])[..., 0]


def fused_contact_plain(a, qfrc, qvel, jf, target, mu, dt, iters, relax):
    """Fused dynamics + contact solve (the batched _fused_contact_single):
    a (B,n,n), qfrc/qvel (B,n), jf (B,c,n) in block row order, target (B,c),
    mu (B,k) -> v_new (B,n)."""
    sol = spd_solve_plain(a, torch.cat([qfrc[..., None],
                                        jf.transpose(1, 2)], 2))
    qacc, w = sol[..., 0], sol[..., 1:]
    v_pred = qvel + dt * qacc
    return contact_sweep_blocks(jf, w, target, mu, v_pred, iters, relax)


def pd_fused_plain(mmat, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, qvel, jf,
                   target, mu, dt, iters, relax):
    """Fused stable-PD substep (the batched _pd_fused_single): mmat
    (B,n,n); kdd (B,n,2) = [jkd_full, dof_damping]; rhspd/e/jkp/jkd/tlim/
    gear/qfb/qvel (B,n); jf (B,c,n); target (B,c); mu (B,k) -> v_new (B,n)."""
    a_pd = mmat + dt * torch.diag_embed(kdd[..., 0])
    qacc = spd_solve_plain(a_pd, rhspd[..., None])[..., 0]
    torque = -jkp * e - jkd * (qvel + dt * qacc)
    torque = torch.clamp(torque, -tlim, tlim)
    qfrc = qfb + torque * gear
    a_dyn = mmat + dt * torch.diag_embed(kdd[..., 1])
    return fused_contact_plain(a_dyn, qfrc, qvel, jf, target, mu, dt, iters,
                               relax)


# the plain versions stand in for the program's kernels K2, K3 and K4
spd_solve = spd_solve_plain
fused_contact = fused_contact_plain
pd_fused = pd_fused_plain
