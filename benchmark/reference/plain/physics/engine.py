"""Batched rigid-body dynamics, plain PyTorch: a frozen copy of
egopose_tpu_torch/physics/engine.py without its kernel dispatch.  Every
path runs its plain version on every device; the stable-PD control
step is the split path, the plain version of the program's K1.

Conventions match MuJoCo: qvel[0:3] world-frame linear velocity of the
root frame origin, qvel[3:6] body-local angular velocity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import quat as Q
from . import linalg
from .fk import Kin, fk, fk_batched
from .model import PhysicsModel, golden_min01

cross = Q.cross


class ContactParams(NamedTuple):
    """Contact-solver / joint-limit parameters and the choice of kernel;
    the same fields and defaults as egopose_tpu.physics.engine.ContactParams.
    The solver flags act on CUDA tensors as in the JAX package on the TPU
    (pd_control_step); on the CPU ``substep_resident`` and ``sparse_ldl``
    are ignored and the others run their kernels' plain versions."""
    margin: float = 1.0e-3   # activation margin (m)
    beta: float = 0.2        # Baumgarte penetration-recovery factor
    slop: float = 1.0e-4     # penetration allowed without correction (m)
    iters: int = 10          # projected-Jacobi iterations
    relax: float = 1.0       # relaxation of the row-sum-scaled sweep
    max_contacts: int = 6    # top-K deepest floor points kept per substep
    max_pair_contacts: int = 6  # top-KP deepest body-body pairs (normal-only
                             # rows; 0 disables self-collision)
    fused_solver: bool = False  # each substep's dynamics solve and contact
                             # sweep in one launch of K3 (step_raw and the
                             # split path, which then refreshes its prep
                             # every substep)
    pd_fused: bool = False   # each stable-PD substep's solves and sweep in
                             # one launch of K4, prep recomputed every
                             # substep; below substep_resident, above
                             # fused_solver in pd_control_step
    substep_resident: bool = False  # the whole control step in one launch
                             # of K1 (CUDA only); takes precedence
    sparse_ldl: bool = True  # K1 solves the PD and dynamics systems by its
                             # sparse tree LDL^T; False: by dense Cholesky,
                             # with the prep recomputed every substep
                             # whatever prep_refresh says (the TPU kernel's
                             # dense branch).  Ignored outside K1
    klim: float = 200.0      # joint-limit stiffness (N m / rad)
    blim: float = 5.0        # joint-limit damping (N m s / rad)
    prep_refresh: int = 1    # recompute FK / mass matrix / bias / contact
                             # geometry (and their factorizations) every
                             # `prep_refresh`-th substep; PD error, limits,
                             # solves, sweep and integration use fresh q/v;
                             # ignored by pd_fused, fused_solver and K1's
                             # dense branch (sparse_ldl=False)


# Same defaults as the JAX engine: the resident kernel K1, prep-refresh R=3.
DEFAULT_CONTACT = ContactParams(substep_resident=True, prep_refresh=3)


def subtree_com(m: PhysicsModel, kin: Kin) -> torch.Tensor:
    """Whole-model center of mass (B,3)."""
    return torch.sum(m.body_mass[:, None] * kin.com, 1) / torch.sum(
        m.body_mass)


# ---------------------------------------------------------------------------
# velocities / inertias
# ---------------------------------------------------------------------------

def spatial_inertia_world(m: PhysicsModel, kin: Kin) -> torch.Tensor:
    """Per-body world-frame inertia about the body com (B,nb,3,3)."""
    r = Q.quat_to_mat(kin.xquat)
    return torch.einsum("nbij,bjk,nblk->nbil", r, m.body_inertia, r)


def _apply_inertia(mass, com, ic, v):
    """I * v for the spatial inertia about the world origin."""
    w, vo = v[..., :3], v[..., 3:]
    p = mass[..., None] * (vo + cross(w, com))
    n = torch.einsum("...ij,...j->...i", ic, w) + cross(com, p)
    return torch.cat([n, p], -1)


def _cross_motion(a, b):
    wa, va = a[..., :3], a[..., 3:]
    wb, vb = b[..., :3], b[..., 3:]
    return torch.cat([cross(wa, wb), cross(wa, vb) + cross(va, wb)], -1)


def _cross_force(v, f):
    w, vl = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(vl, fl), cross(w, fl)], -1)


# ---------------------------------------------------------------------------
# CRBA mass matrix and RNEA bias
# ---------------------------------------------------------------------------

def crba(m: PhysicsModel, kin: Kin) -> torch.Tensor:
    """Composite-rigid-body mass matrix (B,nd,nd), including armature."""
    ic_c = spatial_inertia_world(m, kin)
    eye = torch.eye(3, dtype=kin.xpos.dtype, device=kin.xpos.device)
    c = kin.com
    io = ic_c + m.body_mass[:, None, None] * (
        torch.sum(c * c, -1)[..., None, None] * eye
        - c[..., :, None] * c[..., None, :])
    mom = m.body_mass[:, None] * c
    cmass = m.body_desc_mask @ m.body_mass
    cmom = m.body_desc_mask @ mom
    cio = torch.einsum("bc,ncij->nbij", m.body_desc_mask, io)
    db = list(m.dof_body)
    w, vo = kin.s[..., :3], kin.s[..., 3:]
    cm_d, cmom_d, cio_d = cmass[db], cmom[:, db], cio[:, db]
    p = cm_d[:, None] * vo + cross(w, cmom_d)
    n = torch.einsum("ndij,ndj->ndi", cio_d, w) + cross(cmom_d, vo)
    f = torch.cat([n, p], -1)                           # (B,nd,6)
    u = f @ kin.s.transpose(-1, -2)
    mm = m.anc_mask * u + m.anc_mask.T * (1.0 - m.anc_mask) * u.transpose(
        -1, -2)
    return mm + torch.diag(m.dof_armature)


def bias_force(m: PhysicsModel, kin: Kin, qvel: torch.Tensor) -> torch.Tensor:
    """qfrc_bias (B,nd): gravity + Coriolis/centrifugal, MuJoCo's
    data.qfrc_bias (RNEA with the precomputed vp_mask for S-dot q-dot)."""
    ic_c = spatial_inertia_world(m, kin)
    sq = kin.s * qvel[..., None]
    v = m.body_dof_mask @ sq                            # (B,nb,6)
    v_frame = m.vp_mask @ sq
    cj = _cross_motion(v_frame, sq)
    a0 = torch.cat([m.gravity.new_zeros(3), -m.gravity])
    a = a0 + m.body_dof_mask @ cj
    iv = _apply_inertia(m.body_mass, kin.com, ic_c, v)
    ia = _apply_inertia(m.body_mass, kin.com, ic_c, a)
    f = ia + _cross_force(v, iv)
    ftot = m.body_dof_mask.T @ f                        # (B,nd,6)
    return torch.sum(kin.s * ftot, -1)


# ---------------------------------------------------------------------------
# contacts (floor plane + body-body pairs) and joint limits
# ---------------------------------------------------------------------------

def pair_candidates(m: PhysicsModel, kin: Kin):
    """Body-body candidates, one per enabled geom pair: depth phi (B,PP)
    (positive = overlapping), normal n (B,PP,3) from body2/box toward
    body1/segment, contact point p (B,PP,3).  Segment-box distance is a
    fixed-budget golden-section search (model.golden_min01)."""
    eps = 1e-12
    outs = []
    if m.npair:
        q1, x1 = kin.xquat[:, m.pair_body1], kin.xpos[:, m.pair_body1]
        q2, x2 = kin.xquat[:, m.pair_body2], kin.xpos[:, m.pair_body2]
        a1 = x1 + Q.quat_rotate(q1, m.pair_a1)
        b1 = x1 + Q.quat_rotate(q1, m.pair_b1)
        a2 = x2 + Q.quat_rotate(q2, m.pair_a2)
        b2 = x2 + Q.quat_rotate(q2, m.pair_b2)
        # closest points between segments (Ericson 5.1.9, branch-free)
        d1, d2, r = b1 - a1, b2 - a2, a1 - a2
        A = torch.sum(d1 * d1, -1)
        E = torch.sum(d2 * d2, -1)
        B = torch.sum(d1 * d2, -1)
        C = torch.sum(d1 * r, -1)
        F = torch.sum(d2 * r, -1)
        denom = A * E - B * B
        s = torch.clamp((B * F - C * E) / torch.clamp(denom, min=eps), 0, 1)
        t = torch.clamp((B * s + F) / torch.clamp(E, min=eps), 0, 1)
        s = torch.clamp((B * t - C) / torch.clamp(A, min=eps), 0, 1)
        c1 = a1 + s[..., None] * d1
        c2 = a2 + t[..., None] * d2
        diff = c1 - c2
        dist = torch.sqrt(torch.sum(diff * diff, -1))
        n = diff / torch.clamp(dist, min=1e-9)[..., None]
        phi = m.pair_rsum - dist
        p = 0.5 * (c1 + c2) - 0.5 * m.pair_rdiff[:, None] * n
        outs.append((phi, n, p))
    if m.nbpair:
        qs, xs = kin.xquat[:, m.bpair_body_seg], kin.xpos[:, m.bpair_body_seg]
        qb, xb = kin.xquat[:, m.bpair_body_box], kin.xpos[:, m.bpair_body_box]
        qw = Q.quat_mul(qb, m.bpair_boxquat)           # box world orientation
        cb = xb + Q.quat_rotate(qb, m.bpair_boxpos)
        aw = xs + Q.quat_rotate(qs, m.bpair_a)
        bw = xs + Q.quat_rotate(qs, m.bpair_b)
        al = Q.quat_rotate_inv(qw, aw - cb)            # segment in box frame
        bl = Q.quat_rotate_inv(qw, bw - cb)
        h = m.bpair_half

        def sdist(t):
            qq = al + t[..., None] * (bl - al)
            dout = torch.abs(qq) - h
            mx = torch.amax(dout, -1)                  # inside: -depth
            do = qq - torch.clamp(qq, -h, h)
            return torch.where(mx > 0, torch.sqrt(torch.sum(do * do, -1)), mx)

        t = golden_min01(sdist, al[..., 0])
        qq = al + t[..., None] * (bl - al)
        dout = torch.abs(qq) - h
        mx = torch.amax(dout, -1)
        outside = mx > 0
        cc = torch.clamp(qq, -h, h)
        do = qq - cc
        disto = torch.sqrt(torch.sum(do * do, -1))
        # inside: push out through the nearest face (first max, as argmax)
        onehot = torch.nn.functional.one_hot(torch.argmax(dout, -1),
                                             3).to(qq.dtype)
        n_in = torch.where(qq >= 0, 1.0, -1.0).to(qq.dtype) * onehot
        n_l = torch.where(outside[..., None],
                          do / torch.clamp(disto, min=1e-9)[..., None], n_in)
        signed = torch.where(outside, disto, mx)
        phi_b = m.bpair_rseg - signed
        n_b = Q.quat_rotate(qw, n_l)                   # box -> segment
        pw_t = aw + t[..., None] * (bw - aw)
        p_out = 0.5 * ((cb + Q.quat_rotate(qw, cc))
                       + (pw_t - m.bpair_rseg[:, None] * n_b))
        p_b = torch.where(outside[..., None], p_out, pw_t)
        outs.append((phi_b, n_b, p_b))
    return tuple(torch.cat([o[i] for o in outs], 1) for i in range(3))


def top_k_desc(x: torch.Tensor, k: int):
    """Top-k over the last axis, values descending, ties to the lowest
    index (the JAX engine's _top_k_desc; torch.topk does not fix its tie
    order)."""
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device)
    # a row the reference could not solve is NaN from there on: it still
    # selects valid indices, and its answer stays NaN
    cur = torch.where(torch.isnan(x), -float("inf"), x)
    vals, idxs = [], []
    for _ in range(k):
        mx = torch.amax(cur, -1, keepdim=True)
        first = torch.amin(torch.where(cur >= mx, iota, n), -1)
        vals.append(mx[..., 0])
        idxs.append(first)
        cur = torch.where(iota == first[..., None],
                          torch.full_like(cur, -float("inf")), cur)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B,N,...) rows selected per batch by idx (B,k) -> (B,k,...)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


def contact_blocks(m: PhysicsModel, kin: Kin,
                   params: ContactParams = DEFAULT_CONTACT):
    """Active-contact geometry in block row order: jf (B,3K+KP,nd), target
    (B,3K+KP), mu (B,K).  Rows [0:3K] are the floor contacts ([x; y; z]
    blocks of the top-K deepest floor points, friction mu); rows [3K:] are
    the top-KP deepest body-body pairs, one frictionless normal row each."""
    nd = m.ndof
    dt = m.timestep
    bsz = kin.xpos.shape[0]
    k = min(params.max_contacts, m.ncpoint)
    kp = min(params.max_pair_contacts, m.npair + m.nbpair)

    p_all = kin.xpos[:, m.cpoint_body] + Q.quat_rotate(
        kin.xquat[:, m.cpoint_body], m.cpoint_local)
    phi_all = m.cpoint_radius - p_all[..., 2]
    phi, sel = top_k_desc(phi_all, k)
    p = _gather_rows(p_all, sel)                        # (B,k,3)
    mu = m.cpoint_mu[sel]
    dof_mask = m.point_dof_mask.T[sel]                  # (B,k,nd)
    act = (phi > -params.margin).to(p.dtype)

    s_ang, s_lin = kin.s[..., :3], kin.s[..., 3:]
    jp = s_lin[:, None] + cross(s_ang[:, None].expand(bsz, k, nd, 3),
                                p[:, :, None, :])       # (B,k,nd,3)
    jp = jp * (act[..., None] * dof_mask)[..., None]
    jf = jp.permute(0, 3, 1, 2).reshape(bsz, 3 * k, nd)
    vn_target = torch.clamp(
        params.beta * torch.clamp(phi - params.slop, min=0.0) / dt,
        max=1.0) * act
    target = torch.cat([phi.new_zeros(bsz, 2 * k), vn_target], 1)

    if kp:
        phi_p, n_p, p_p = pair_candidates(m, kin)
        smask_all = torch.cat([m.pair_dof_mask, m.bpair_dof_mask], 1)
        php, selp = top_k_desc(phi_p, kp)
        n_sel, p_sel = _gather_rows(n_p, selp), _gather_rows(p_p, selp)
        sm = smask_all.T[selp]                          # (B,kp,nd) signed
        actp = (php > -params.margin).to(p.dtype)
        pxn = cross(p_sel, n_sel)
        rows = torch.einsum("ndi,nki->nkd", s_lin, n_sel) \
            + torch.einsum("ndi,nki->nkd", s_ang, pxn)
        rows = rows * (actp[..., None] * sm)
        vn_p = torch.clamp(
            params.beta * torch.clamp(php - params.slop, min=0.0) / dt,
            max=1.0) * actp
        jf = torch.cat([jf, rows], 1)
        target = torch.cat([target, vn_p], 1)
    return jf, target, mu


def limit_qfrc(m: PhysicsModel, qpos, qvel,
               params: ContactParams = DEFAULT_CONTACT) -> torch.Tensor:
    """Soft joint-limit torques for limited hinge dofs (B,nd)."""
    q = qpos[:, 7:]
    dq = qvel[:, 6:]
    below = torch.clamp(m.jnt_range[:, 0] - q, min=0.0)
    above = torch.clamp(q - m.jnt_range[:, 1], min=0.0)
    viol = ((below > 0) | (above > 0)).to(qpos.dtype)
    tau = (params.klim * (below - above) - viol * params.blim * dq) \
        * m.jnt_limited_f
    return torch.cat([qpos.new_zeros(qpos.shape[0], 6), tau], 1)


# ---------------------------------------------------------------------------
# forward dynamics + integration
# ---------------------------------------------------------------------------

def smooth_dynamics(m: PhysicsModel, qpos, qvel, tau, params: ContactParams,
                    mm, qfrc_bias):
    """Constraint-free generalized force and the implicitly damped inertia
    (M + dt diag(damping)) of MuJoCo's Euler integrator, given the mass
    matrix and bias force of the (possibly frozen) prep."""
    stiff = torch.cat([qpos.new_zeros(qpos.shape[0], 6),
                       m.dof_stiffness[6:] * qpos[:, 7:]], 1)
    qfrc = tau - qfrc_bias + limit_qfrc(m, qpos, qvel, params) \
        - m.dof_damping * qvel - stiff
    a = mm + m.timestep * torch.diag(m.dof_damping)
    return qfrc, a


def integrate(m: PhysicsModel, qpos, qvel, dt) -> torch.Tensor:
    """Semi-implicit position update (mj_integratePos)."""
    pos = qpos[:, :3] + dt * qvel[:, :3]
    quat = Q.quat_integrate(qpos[:, 3:7], qvel[:, 3:6], dt)
    joints = qpos[:, 7:] + dt * qvel[:, 6:]
    return torch.cat([pos, quat, joints], 1)


def prep_fk(m: PhysicsModel, qpos, params: ContactParams) -> Kin:
    """The FK of a substep's prep: fk_batched under the fused options, fk
    otherwise (module docstring)."""
    fused = params.fused_solver or params.pd_fused
    return (fk_batched if fused else fk)(m, qpos)


def step_raw(m: PhysicsModel, qpos, qvel, tau,
             params: ContactParams = DEFAULT_CONTACT):
    """One physics substep at m.timestep with generalized applied force tau
    (B,nd): smooth dynamics -> predicted velocity -> contact projection ->
    integrate.  The dynamics solve and the Delassus columns W = Minv J^T
    share one SPD solve (linalg.spd_solve: the K2 kernel on the card); with
    ``fused_solver`` the solve and the sweep are one linalg.fused_contact
    (the K3 kernel on the card)."""
    kin = prep_fk(m, qpos, params)
    qfrc, a = smooth_dynamics(m, qpos, qvel, tau, params, crba(m, kin),
                              bias_force(m, kin, qvel))
    jf, target, mu = contact_blocks(m, kin, params)
    if params.fused_solver:
        qvel = linalg.fused_contact(a, qfrc, qvel, jf, target, mu,
                                    m.timestep, params.iters, params.relax)
    else:
        sol = linalg.spd_solve(a, torch.cat([qfrc[..., None],
                                             jf.transpose(1, 2)], 2))
        qacc, w = sol[..., 0], sol[..., 1:]
        v_pred = qvel + m.timestep * qacc
        qvel = linalg.contact_sweep_blocks(jf, w, target, mu, v_pred,
                                           params.iters, params.relax)
    return integrate(m, qpos, qvel, m.timestep), qvel


# ---------------------------------------------------------------------------
# stable-PD control step
# ---------------------------------------------------------------------------

def stable_pd_torque(m: PhysicsModel, qpos, qvel, ctrl, jkp, jkd, mm,
                     qfrc_bias, solve=linalg.spd_solve_plain) -> torch.Tensor:
    """Stable-PD actuator torque (B,nu): solve (M + Kd dt) qacc =
    -C - Kp e - Kd edot with ``solve``, then tau = -kp e - kd (edot +
    qacc dt)."""
    dt = m.timestep
    z6 = qpos.new_zeros(qpos.shape[0], 6)
    k_p = torch.cat([z6, jkp.expand(qpos.shape[0], -1)], 1)
    k_d = torch.cat([z6, jkd.expand(qpos.shape[0], -1)], 1)
    qpos_err = torch.cat([z6, qpos[:, 7:] - ctrl], 1)
    rhs = -qfrc_bias - k_p * qpos_err - k_d * qvel
    a = mm + dt * torch.diag_embed(k_d)
    qacc = solve(a, rhs[..., None])[..., 0]
    qvel_err = qvel + qacc * dt
    return -jkp * qpos_err[:, 6:] - jkd * qvel_err[:, 6:]


def pd_control_step_split(m: PhysicsModel, qpos, qvel, ctrl, jkp, jkd,
                          torque_lim, n_frames: int,
                          params: ContactParams = DEFAULT_CONTACT,
                          solve=linalg.spd_solve_plain):
    """The split-path control step: n_frames substeps of stable-PD torque +
    dynamics + contact sweep + integration, grouped by the prep-refresh
    cadence R (the last group takes the remainder).  The SPD solves go
    through ``solve``: the plain version by default, which makes this K1's
    plain version -- at prep_refresh=1 that of K1's dense branch
    (sparse_ldl=False), which recomputes the prep every substep whatever
    prep_refresh says; pd_control_step passes linalg.spd_solve (K2 on the
    card).
    With ``fused_solver`` R is 1 and each substep's dynamics solve and
    sweep are one linalg.fused_contact (the K3 kernel on the card)."""
    act = list(m.actuator_dof)
    fused = params.fused_solver
    r = 1 if fused else max(1, int(params.prep_refresh))

    def group(qp, qv, nsub):
        # FK, mass matrix, bias and contact geometry from the group-entry
        # state, reused by the group's substeps
        kin = prep_fk(m, qp, params)
        mm = crba(m, kin)
        qfrc_bias = bias_force(m, kin, qv)
        jf, target, mu = contact_blocks(m, kin, params)
        for _ in range(nsub):
            torque = stable_pd_torque(m, qp, qv, ctrl, jkp, jkd, mm,
                                      qfrc_bias, solve)
            torque = torch.clamp(torque, -torque_lim, torque_lim)
            tau = qp.new_zeros(qp.shape[0], m.ndof)
            tau[:, act] = torque * m.actuator_gear
            qfrc, a = smooth_dynamics(m, qp, qv, tau, params, mm, qfrc_bias)
            if fused:
                qv = linalg.fused_contact(a, qfrc, qv, jf, target, mu,
                                          m.timestep, params.iters,
                                          params.relax)
            else:
                sol = solve(a, torch.cat([qfrc[..., None],
                                          jf.transpose(1, 2)], 2))
                qacc, w = sol[..., 0], sol[..., 1:]
                v_pred = qv + m.timestep * qacc
                qv = linalg.contact_sweep_blocks(jf, w, target, mu, v_pred,
                                                 params.iters, params.relax)
            qp = integrate(m, qp, qv, m.timestep)
        return qp, qv

    for _ in range(n_frames // r):
        qpos, qvel = group(qpos, qvel, r)
    if n_frames % r:
        qpos, qvel = group(qpos, qvel, n_frames % r)
    return qpos, qvel


def pd_fused_gains(m: PhysicsModel, bsz: int, jkp, jkd, torque_lim):
    """The per-dof gains of the fused stable-PD substep, (B,nd) each:
    jkp_full, jkd_full, tlim_full, gear_full and kdd = [jkd_full,
    dof_damping] (B,nd,2), the diagonal additions of its two systems.
    Gains and limits may be (nu,) or (B,nu)."""
    act = list(m.actuator_dof)
    lanes = lambda x: x.to(m.dtype).expand(bsz, -1)
    z6 = m.dof_damping.new_zeros(bsz, 6)
    jkp_full = torch.cat([z6, lanes(jkp)], 1)
    jkd_full = torch.cat([z6, lanes(jkd)], 1)
    gear_full = m.dof_damping.new_zeros(bsz, m.ndof)
    gear_full[:, act] = m.actuator_gear
    tlim_full = m.dof_damping.new_zeros(bsz, m.ndof)
    tlim_full[:, act] = lanes(torque_lim)
    kdd = torch.stack([jkd_full, m.dof_damping.expand(bsz, -1)], -1)
    return jkp_full, jkd_full, tlim_full, gear_full, kdd


def pd_fused_terms(m: PhysicsModel, qpos, qvel, ctrl, jkp_full, jkd_full,
                   kin: Kin, params: ContactParams):
    """The state-dependent inputs of one fused stable-PD substep at (qpos,
    qvel): mass matrix, PD rhs, position error, passive + bias force and
    the contact blocks -- (mm, rhspd, e, qfb, jf, target, mu)."""
    mm = crba(m, kin)
    qfrc_bias = bias_force(m, kin, qvel)
    z6 = qpos.new_zeros(qpos.shape[0], 6)
    e = torch.cat([z6, qpos[:, 7:] - ctrl], 1)
    rhspd = -qfrc_bias - jkp_full * e - jkd_full * qvel
    qfb = -qfrc_bias + limit_qfrc(m, qpos, qvel, params) \
        - m.dof_damping * qvel \
        - torch.cat([z6, m.dof_stiffness[6:] * qpos[:, 7:]], 1)
    jf, target, mu = contact_blocks(m, kin, params)
    return mm, rhspd, e, qfb, jf, target, mu


def _pd_fused_control_step(m: PhysicsModel, qpos, qvel, ctrl, jkp, jkd,
                           torque_lim, n_frames: int,
                           params: ContactParams = DEFAULT_CONTACT):
    """pd_control_step with each substep's solve chain (stable-PD solve ->
    torque clamp -> dynamics + Delassus solve -> contact sweep) in one
    linalg.pd_fused (the K4 kernel on the card).  FK, mass matrix, bias and
    contacts are recomputed every substep: prep_refresh does not apply."""
    gains = pd_fused_gains(m, qpos.shape[0], jkp, jkd, torque_lim)
    jkp_full, jkd_full, tlim_full, gear_full, kdd = gains
    for _ in range(n_frames):
        mm, rhspd, e, qfb, jf, target, mu = pd_fused_terms(
            m, qpos, qvel, ctrl, jkp_full, jkd_full, prep_fk(m, qpos, params),
            params)
        qvel = linalg.pd_fused(mm, kdd, rhspd, e, jkp_full, jkd_full,
                               tlim_full, gear_full, qfb, qvel, jf, target,
                               mu, m.timestep, params.iters, params.relax)
        qpos = integrate(m, qpos, qvel, m.timestep)
    return qpos, qvel


def torque_control_step(m: PhysicsModel, qpos, qvel, ctrl, torque_lim,
                        n_frames: int,
                        params: ContactParams = DEFAULT_CONTACT):
    """One control step with action_type 'torque' (humanoid_v1.py:170-171):
    the clamped, geared torque held over n_frames substeps of step_raw."""
    torque = torch.clamp(ctrl, -torque_lim, torque_lim)
    tau = qpos.new_zeros(qpos.shape[0], m.ndof)
    tau[:, list(m.actuator_dof)] = torque * m.actuator_gear
    for _ in range(n_frames):
        qpos, qvel = step_raw(m, qpos, qvel, tau, params)
    return qpos, qvel


def pd_control_step(m: PhysicsModel, qpos, qvel, ctrl, jkp, jkd, torque_lim,
                    n_frames: int, params: ContactParams = DEFAULT_CONTACT):
    """One stable-PD control step for a batch (B,nq)/(B,nd)/(B,nu).

    The JAX engine's dispatch, in its order of precedence: with
    ``substep_resident`` a CUDA batch runs K1, the whole control step in one
    launch (physics/substep.py; a model K1 does not take raises), by its
    sparse tree LDL^T or, with ``sparse_ldl=False``, by its dense branch;
    otherwise
    ``pd_fused`` runs _pd_fused_control_step (K4 on the card), and else the
    split path above runs with its solves through linalg.spd_solve (K2 on
    the card), as the JAX split path solves through K2 on the TPU.  On the
    CPU ``substep_resident`` is ignored, as off the TPU in the JAX package.
    Gains and limits may be (nu,) (shared) or (B,nu)."""
    if params.pd_fused:
        return _pd_fused_control_step(m, qpos, qvel, ctrl, jkp, jkd,
                                      torque_lim, n_frames, params)
    return pd_control_step_split(m, qpos, qvel, ctrl, jkp, jkd, torque_lim,
                                 n_frames, params, solve=linalg.spd_solve)
