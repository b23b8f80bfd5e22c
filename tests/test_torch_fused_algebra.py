"""The algebra of the fused kernels K3 and K4 (csrc/fused_contact.cu), on
the CPU in float64, without a card.

The kernels solve forward only: with A = L L^T (pivots floored at 1e-12),
Z = L^-1 [dt qfrc | J^T], D = Z_c^T Z_c (= J A^-1 J^T, lower triangle
mirrored), bhat = J qvel + Z_c^T z0 - target, lam from the projected
Jacobi sweep on D, and v_new = qvel + L^-T (z0 + Z_c lam); K4 first solves
its PD column (M + dt diag(kdd0))^-1 rhspd by one forward and one back
substitution.  ``contact_algebra`` and ``pd_algebra`` below follow the
kernels' stages and orders (left-looking factor by column, the
dot-form forward substitution that runs beside it, back substitution
from the last row, the sweep with relax / (row sum + 1e-9)), batched over
systems.  They are held against
linalg.fused_contact_plain / pd_fused_plain (which form W = A^-1 J^T and
J W) at 1e-12 of max|v|, and against the JAX package's
_fused_contact_single / _pd_fused_single at 1e-10, on
tests/test_torch_fused.py's systems (c=48, k=16 and c=24, k=8), at the
humanoid's shape (c=24, k=6), with more rows than two per lane (c=64,
c=70), without friction rows (k=0) and without sweep iterations
(iters=0).

Also: the stage-clock reduction (linalg.fused_stage_cycles) reads each
warp's stamps in time order.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egopose_tpu.physics import linalg_pallas as LP
from egopose_tpu_torch.physics import linalg
from test_torch_fused import _contact_inputs, _pd_inputs

DT = 1.0 / 450


def _factor(a):
    """Left-looking Cholesky by column with every pivot floored at 1e-12
    (cholesky.cuh's warp_cholesky): L and 1 / diag(L)."""
    bsz, n, _ = a.shape
    low = torch.zeros_like(a)
    rdiag = torch.empty(bsz, n, dtype=a.dtype)
    for j in range(n):
        s = a[:, j:, j] - (low[:, j:, :j] @ low[:, j, :j, None])[..., 0]
        piv = s[:, 0]
        root = torch.sqrt(torch.clamp(piv, min=1e-12))
        inv = 1.0 / root
        low[:, j:, j] = s * inv[:, None]
        rdiag[:, j] = torch.where(piv >= 1e-12, inv, root / piv)
    return low, rdiag


def _forward(low, rdiag, rhs):
    """L^-1 rhs (B,n,r), dot form by row (fused_contact.cu's SubstRider,
    which forms row j beside the factor's column j)."""
    z = rhs.clone()
    for j in range(low.shape[1]):
        z[:, j] = (rhs[:, j] - (low[:, j, None, :j] @ z[:, :j])[:, 0]) \
            * rdiag[:, j, None]
    return z


def _backward(low, rdiag, y):
    """L^-T y (B,n), from the last row (warp_ltsolve_vec)."""
    y = y.clone()
    for j in range(low.shape[1] - 1, -1, -1):
        y[:, j] = y[:, j] * rdiag[:, j]
        y[:, :j] -= low[:, j, :j] * y[:, j, None]
    return y


def _sweep(d, bhat, mu, iters, relax):
    """The projected-Jacobi sweep as the kernel runs it: friction box on
    the first 3k rows, lam >= 0 on the trailing pair rows."""
    k = mu.shape[1]
    gid = relax / (d.abs().sum(1) + 1e-9)        # D is symmetric
    lam = torch.zeros_like(bhat)
    for _ in range(iters):
        lnew = lam - ((d @ lam[..., None])[..., 0] + bhat) * gid
        lim = mu * torch.clamp(lnew[:, 2 * k:3 * k], min=0.0)
        lam = torch.cat([torch.minimum(torch.maximum(lnew[:, :k], -lim), lim),
                         torch.minimum(torch.maximum(lnew[:, k:2 * k], -lim),
                                       lim),
                         torch.clamp(lnew[:, 2 * k:], min=0.0)], 1)
    return lam


def contact_algebra(a, qfrc, qvel, jf, target, mu, dt, iters, relax,
                    factor=None):
    """K3's stages: factor, Z = L^-1 [dt qfrc | J^T] with J qvel read off
    the J^T columns, D = Z_c^T Z_c (lower triangle, mirrored), bhat, the
    sweep, v_new = qvel + L^-T (z0 + Z_c lam)."""
    low, rdiag = factor if factor is not None else _factor(a)
    rhs = torch.cat([(dt * qfrc)[..., None], jf.transpose(1, 2)], 2)
    jq = (rhs[..., 1:] * qvel[..., None]).sum(1)
    z = _forward(low, rdiag, rhs)
    z0, zc = z[..., 0], z[..., 1:]
    d = torch.tril(zc.transpose(1, 2) @ zc)
    d = d + torch.tril(d, -1).transpose(1, 2)
    bhat = jq + (zc * z0[..., None]).sum(1) - target
    lam = _sweep(d, bhat, mu, iters, relax)
    y = z0 + (zc @ lam[..., None])[..., 0]
    return qvel + _backward(low, rdiag, y)


def pd_algebra(mmat, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, qvel, jf,
               target, mu, dt, iters, relax):
    """K4's stages: the PD column by one forward and one back substitution
    on A_pd's factor, the clamped torque, dt qfrc, then K3's stages on
    A_dyn."""
    lp, rp = _factor(mmat + dt * torch.diag_embed(kdd[..., 0]))
    qacc = _backward(lp, rp, _forward(lp, rp, rhspd[..., None])[..., 0])
    torque = -jkp * e - jkd * (qvel + dt * qacc)
    torque = torch.minimum(torch.maximum(torque, -tlim), tlim)
    qfrc = qfb + torque * gear
    return contact_algebra(mmat + dt * torch.diag_embed(kdd[..., 1]), qfrc,
                           qvel, jf, target, mu, dt, iters, relax)


def _inputs(seed, b, c, k):
    """tests/test_torch_fused.py's contact recipe at (B, c, k), n = 58."""
    rng = np.random.RandomState(seed)
    n = 58
    x = rng.randn(b, n, n)
    a = np.einsum("bij,bkj->bik", x, x) + 10 * np.eye(n)
    return (a, rng.randn(b, n), rng.randn(b, n), rng.randn(b, c, n) * 0.3,
            np.abs(rng.randn(b, c)) * 0.1, np.abs(rng.randn(b, k)) + 0.2)


def _pd_from(contact, seed):
    """K4's inputs around a contact system: M = its A, the recipe of
    tests/test_torch_fused.py's _pd_inputs for the rest."""
    a, qfrc, qvel, jf, target, mu = contact
    rng = np.random.RandomState(seed)
    b, n = qvel.shape
    kdd = np.abs(rng.randn(b, n, 2))
    rhspd, e, jkp, jkd = (rng.randn(b, n) for _ in range(4))
    tlim, gear = np.abs(rng.randn(b, n)), np.abs(rng.randn(b, n))
    return (a, kdd, rhspd, e, jkp, jkd, tlim, gear, qfrc, qvel, jf, target,
            mu)


CONTACT_CASES = {
    "fused_c48_k16": lambda: (_contact_inputs(0), 25),
    "humanoid_c24_k6": lambda: (_inputs(7, 4, 24, 6), 10),
    "pairs_only_k0": lambda: (_inputs(8, 3, 6, 0), 10),
    "no_iterations": lambda: (_inputs(9, 3, 24, 6), 0),
    "wide_c70_k20": lambda: (_inputs(17, 2, 70, 20), 10),
}
PD_CASES = {
    "pd_c24_k8": lambda: (_pd_inputs(1), 25),
    "humanoid_c24_k6": lambda: (_pd_from(_inputs(10, 4, 24, 6), 11), 10),
    "pairs_only_k0": lambda: (_pd_from(_inputs(12, 3, 6, 0), 13), 10),
    "no_iterations": lambda: (_pd_from(_inputs(14, 3, 48, 16), 15), 0),
    "wide_c64_k16": lambda: (_pd_from(_inputs(18, 2, 64, 16), 19), 10),
}


def _hold(got, plain, want_jax):
    scale = float(plain.abs().max())
    assert torch.isfinite(got).all()
    assert float((got - plain).abs().max()) <= 1e-12 * scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("case", list(CONTACT_CASES))
def test_contact_algebra_matches_plain_and_jax(case):
    args, iters = CONTACT_CASES[case]()
    t = [torch.tensor(x) for x in args]
    got = contact_algebra(*t, DT, iters, 1.0)
    plain = linalg.fused_contact_plain(*t, DT, iters, 1.0)
    want = jax.vmap(lambda *x: LP._fused_contact_single(
        *x, DT, iters, 1.0))(*map(jnp.asarray, args))
    _hold(got, plain, want)


@pytest.mark.parametrize("case", list(PD_CASES))
def test_pd_algebra_matches_plain_and_jax(case):
    args, iters = PD_CASES[case]()
    t = [torch.tensor(x) for x in args]
    got = pd_algebra(*t, DT, iters, 1.0)
    plain = linalg.pd_fused_plain(*t, DT, iters, 1.0)
    want = jax.vmap(lambda *x: LP._pd_fused_single(
        *x, DT, iters, 1.0))(*map(jnp.asarray, args))
    _hold(got, plain, want)


def test_without_iterations_v_new_is_v_pred():
    """iters = 0: lam = 0, so v_new = qvel + dt A^-1 qfrc."""
    a, qfrc, qvel, jf, target, mu = map(torch.tensor, _inputs(16, 3, 24, 6))
    got = contact_algebra(a, qfrc, qvel, jf, target, mu, DT, 0, 1.0)
    want = qvel + DT * torch.linalg.solve(a, qfrc)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_factor_floors_the_pivot():
    """A pivot below 1e-12 is floored before its reciprocal square root,
    as the kernel's and the JAX package's factors do: rdiag stays
    1 / L[j][j] and the factor stays finite."""
    a = torch.diag(torch.tensor([4.0, 1e-20, 9.0], dtype=torch.float64))[None]
    low, rdiag = _factor(a)
    assert torch.isfinite(low).all() and torch.isfinite(rdiag).all()
    torch.testing.assert_close(rdiag * torch.diagonal(low, dim1=1, dim2=2),
                               torch.ones(1, 3, dtype=torch.float64),
                               rtol=1e-15, atol=0)
    assert float(low[0, 1, 1]) == pytest.approx(1e-20 / 1e-6, rel=1e-15)


def test_stage_cycles_follow_each_warps_stamps():
    """linalg.fused_stage_cycles: a stage's cycles are its stamp minus the
    warp's previous stamp in time, whatever the order of FUSED_STAGES; a
    stage the warp did not stamp, and ``start``, count 0."""
    names = linalg.FUSED_STAGES
    clocks = torch.zeros(2, len(names), dtype=torch.int64)
    for row, stamps in enumerate(({"start": 100, "load": 150, "factor": 400,
                                   "prep": 420},
                                  {"start": 10, "load": 30,
                                   "pd_factor": 95, "torque": 99})):
        for name, t in stamps.items():
            clocks[row, names.index(name)] = t
    cyc = linalg.fused_stage_cycles(clocks)
    want = {0: {"load": 50, "factor": 250, "prep": 20},
            1: {"load": 20, "pd_factor": 65, "torque": 4}}
    for row, stages in want.items():
        for i, name in enumerate(names):
            assert float(cyc[row, i]) == stages.get(name, 0)
