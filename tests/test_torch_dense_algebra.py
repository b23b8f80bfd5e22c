"""The per-substep algebra of K1's dense branch (csrc/substep.cu,
ContactParams.sparse_ldl=False), on the CPU in float64, without a card.

After the prep, the kernel solves each substep as K4 does, forward only:
with A_pd = M + dt diag(kd) and A_dyn = M + dt diag(damping) = L L^T
(pivots floored at 1e-12), the PD column's forward half rides on A_pd's
factor and its back substitution follows; Y = L^-1 J^T rides on A_dyn's
factor with J v read off the J^T columns; D = Y^T Y (lower triangle,
mirrored); the torque and dt qfrc; z0 = L^-1 (dt qfrc); the residual
J v + Y^T z0 - target; the projected-Jacobi sweep on D; and v_new =
v + L^-T (z0 + Y lam).  ``dense_algebra`` below follows those stages and
orders (tests/test_torch_fused_algebra.py's factor, substitutions and
sweep), batched over environments.  It is held, on contact-rich humanoid
states (n = 58, c = 24, k = 6) with the subject_03 gains, with the sweep's
10 iterations and with none:

- against one substep of the port's plain dense path (the split path at
  R=1, engine.pd_control_step_split, which forms W = A_dyn^-1 J^T and
  J W) at 1e-12 of max|v|;
- against the TPU kernel's dense branch (substep_pallas.py:784-830):
  linalg_pallas._factor_multi, _subst_multi, _subst_blocked and
  _contact_sweep over the contact-loaded dofs (``sup_segs``), run as one
  Pallas kernel in interpret mode as the JAX package's own tests run its
  kernels on the CPU, at 1e-10.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from egopose_tpu.physics import engine as je
from egopose_tpu.physics import linalg_pallas as LP
from egopose_tpu.physics import substep_pallas as SP
from egopose_tpu_torch.physics import engine as te
from test_torch_dense_k1 import DENSE, _one_torch_thread, world  # noqa: F401
from test_torch_fused_algebra import _backward, _factor, _forward, _sweep


def substep_inputs(tm, q, v, ctrl, gains, params):
    """The dense substep's inputs at (q, v) from the engine's prep:
    M, kdd = [kd, damping], the PD rhs, position error, per-dof gains,
    torque limits and gear, the passive + bias force, J, target, mu."""
    bsz = q.shape[0]
    jkp, jkd, tlim, gear, kdd = te.pd_fused_gains(tm, bsz, *gains)
    mm, rhspd, e, qfb, jf, target, mu = te.pd_fused_terms(
        tm, q, v, ctrl, jkp, jkd, te.fk(tm, q), params)
    return mm, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, v, jf, target, mu


def dense_algebra(mm, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, v, jf,
                  target, mu, dt, iters, relax):
    """The kernel's stages: both factors, the PD column (forward half
    beside A_pd's factor, then back), Y = L^-1 J^T and J v beside A_dyn's
    factor, D = Y^T Y mirrored, the torque, z0, the residual, the sweep,
    v + L^-T (z0 + Y lam)."""
    lp, rp = _factor(mm + dt * torch.diag_embed(kdd[..., 0]))
    ld, rd = _factor(mm + dt * torch.diag_embed(kdd[..., 1]))
    xpd = _forward(lp, rp, rhspd[..., None])[..., 0]
    jt = jf.transpose(1, 2)
    y = _forward(ld, rd, jt)
    jv = (jt * v[..., None]).sum(1)
    xpd = _backward(lp, rp, xpd)
    d = torch.tril(y.transpose(1, 2) @ y)
    d = d + torch.tril(d, -1).transpose(1, 2)
    torque = torch.clamp(-jkp * e - jkd * (v + dt * xpd), -tlim, tlim)
    z0 = _forward(ld, rd, (dt * (qfb + torque * gear))[..., None])[..., 0]
    bhat = jv + (y * z0[..., None]).sum(1) - target
    lam = _sweep(d, bhat, mu, iters, relax)
    return v + _backward(ld, rd, z0 + (y @ lam[..., None])[..., 0])


def _tpu_dense_kernel(mm_ref, kpd_ref, kdyn_ref, rhspd_ref, e_ref, jkp_ref,
                      jkd_ref, tlim_ref, gear_ref, qfb_ref, v_ref, jf_ref,
                      tgt_ref, mu_ref, out_ref, a_s, a2_s, xpd_s, x_s, *, n,
                      c, k, dt, iters, relax, sup_segs):
    """substep_pallas.py's dense branch after the prep, one substep
    (lane-major: (n, n, L), (n, L), jf (c, n, L), target (c, 1, L), mu
    (k, 1, L)); per-dof gains, limits and gear are zero on the root's dofs,
    so its torque there is zero, as the kernel's concatenation has it."""
    shape = (n, n, mm_ref.shape[-1])
    eq = jax.lax.broadcasted_iota(jnp.int32, shape, 0) == \
        jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    mmat = mm_ref[...]
    a_s[...] = mmat + jnp.where(eq, dt * kpd_ref[...][:, None, :], 0.0)
    a2_s[...] = mmat + jnp.where(eq, dt * kdyn_ref[...][:, None, :], 0.0)
    LP._factor_multi([a_s, a2_s], n)
    xpd_s[...] = rhspd_ref[...][:, None, :]
    x_s[...] = jnp.stack([jf_ref[i] for i in range(c)], axis=1)
    LP._subst_multi([(a_s, xpd_s), (a2_s, x_s)], n)
    qacc_pd = xpd_s[...][:, 0, :]
    v = v_ref[...]
    torque = jnp.clip(-jkp_ref[...] * e_ref[...]
                      - jkd_ref[...] * (v + dt * qacc_pd),
                      -tlim_ref[...], tlim_ref[...])
    qfrc = qfb_ref[...] + torque * gear_ref[...]
    xpd_s[...] = (qfrc * dt)[:, None, :]
    LP._subst_blocked(a2_s, xpd_s, n)
    v_pred = v[:, None, :] + xpd_s[...]
    out_ref[...] = LP._contact_sweep(jf_ref, tgt_ref, mu_ref, x_s, v_pred,
                                     n, c, k, iters, relax, xcol0=0,
                                     sup_segs=sup_segs)[:, 0, :]


def tpu_dense(args, dt, iters, relax, sup_segs):
    """The TPU kernel's dense substep in interpret mode, batch on lanes."""
    (mm, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, v, jf, target,
     mu) = [np.asarray(a) for a in args]
    bsz, n, _ = mm.shape
    c, k = jf.shape[1], mu.shape[1]
    lane = lambda x: jnp.asarray(np.moveaxis(x, 0, -1))
    ins = [lane(mm), lane(kdd[..., 0]), lane(kdd[..., 1])] \
        + [lane(x) for x in (rhspd, e, jkp, jkd, tlim, gear, qfb, v, jf)] \
        + [lane(target[..., None]), lane(mu[..., None])]
    out = pl.pallas_call(
        functools.partial(_tpu_dense_kernel, n=n, c=c, k=k, dt=dt,
                          iters=iters, relax=relax, sup_segs=sup_segs),
        out_shape=jax.ShapeDtypeStruct((n, bsz), jnp.float64),
        interpret=True,
        scratch_shapes=[pltpu.VMEM((n, n, bsz), jnp.float64),
                        pltpu.VMEM((n, n, bsz), jnp.float64),
                        pltpu.VMEM((n, 1, bsz), jnp.float64),
                        pltpu.VMEM((n, c, bsz), jnp.float64)],
    )(*ins)
    return np.asarray(out).T


@pytest.mark.parametrize("iters", [10, 0], ids=["sweep", "no_iterations"])
def test_dense_algebra_matches_plain_and_jax(world, iters):
    spec, jm, tm, q, v, ctrl, gains = world
    params = DENSE._replace(prep_refresh=1, iters=iters)
    t = lambda x: torch.tensor(x)
    g = [t(x) for x in gains]
    args = substep_inputs(tm, t(q), t(v), t(ctrl), g, params)
    assert args[-3].shape[1:] == (24, 58) and args[-1].shape[1] == 6
    assert bool((args[-3] != 0).any(2).any(1).all())      # contacts active
    dt, relax = tm.timestep, params.relax
    got = dense_algebra(*args, dt, iters, relax)
    assert torch.isfinite(got).all()
    # the port's plain dense path: one substep of the split path at R=1
    _, plain = te.pd_control_step_split(tm, t(q), t(v), t(ctrl), *g, 1,
                                        params)
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-12 * scale
    # the TPU kernel's dense branch, over the contact-loaded dofs
    sup = SP._build_static(jm, je.DEFAULT_CONTACT._replace(
        sparse_ldl=False))["sup_segs"]
    want = tpu_dense([a.numpy() for a in args], dt, iters, relax, sup)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
