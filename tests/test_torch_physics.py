"""Physics of egopose_tpu_torch against the JAX engine, float64 on the CPU
at B=4: fk / crba / bias_force / contact_blocks to 1e-10 (the JAX engine
holds itself to 1e-9..1e-12 against MuJoCo C, tests/test_physics_golden.py),
one stable-PD control step at prep-refresh R=1, R=3 and R=2 (remainder
group) to 1e-9, one torque-mode control step (15 substeps of step_raw,
whose solve is the K2 dispatch) to 1e-9, and the model tables.  The states are contact-rich: feet
pressed 3-10 mm into the floor and flailing arms, so floor and pair rows
are active."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from egopose_tpu.physics import build_model as jbuild, engine as je
from egopose_tpu.physics.spec import parse_mjcf as jparse
from egopose_tpu_torch.physics import engine as te, model as tmodel, substep
from egopose_tpu_torch.physics.spec import parse_mjcf as tparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
B = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores, and the port's small
    CPU tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    spec = jparse(XML)
    jm = jbuild(spec, dtype=jnp.float64)
    tm = tmodel.build_model(tparse(XML), dtype=torch.float64)
    rng = np.random.RandomState(7)
    q = np.zeros((B, spec.nq))
    tilt = rng.normal(0, 0.03, (B, 3))
    q[:, 3:7] = np.c_[np.ones(B), 0.5 * tilt]
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(-0.15, 0.15, (B, spec.nq - 7))
    for side in ("Right", "Left"):
        for ax in "xyz":
            q[:, 7 + spec.jnt_names.index(f"{side}Arm_{ax}")] += \
                rng.uniform(-1.2, 1.2, B)
    kin = te.fk(tm, torch.tensor(q))
    pts = kin.xpos[:, tm.cpoint_body] + te.Q.quat_rotate(
        kin.xquat[:, tm.cpoint_body], tm.cpoint_local)
    low = torch.amin(pts[..., 2] - tm.cpoint_radius, 1).numpy()
    q[:, 2] -= low + rng.uniform(0.003, 0.010, B)
    v = rng.normal(0, 0.5, (B, spec.ndof))
    ctrl = q[:, 7:] + rng.normal(0, 0.1, (B, spec.nu))
    cfg = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                           "subject_03.yml")))
    jp = list(zip(*cfg["joint_params"]))
    gains = (np.array(jp[1], float) * 0.5, np.array(jp[2], float) * 0.5,
             np.array(jp[5], float))
    return spec, jm, tm, q, v, ctrl, gains


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


def test_fk_crba_bias_contacts_match_jax(world):
    spec, jm, tm, q, v, _, _ = world
    def jax_all(x, qv):
        kin = je.fk(jm, x)
        return (kin, je.crba(jm, kin), je.bias_force(jm, kin, qv),
                je.contact_blocks(jm, kin))

    kin_j, mm_j, bias_j, (jf_j, tg_j, mu_j) = jax.jit(jax.vmap(jax_all))(
        jnp.asarray(q), jnp.asarray(v))
    kin_t = te.fk(tm, torch.tensor(q))
    for name, a, b in zip(kin_t._fields, kin_t, kin_j):
        _close(a, b, 1e-10, name)
    _close(te.crba(tm, kin_t), mm_j, 1e-10, "crba")
    _close(te.bias_force(tm, kin_t, torch.tensor(v)), bias_j, 1e-10, "bias")
    jf_t, tg_t, mu_t = te.contact_blocks(tm, kin_t)
    for name, a, b in (("jf", jf_t, jf_j), ("target", tg_t, tg_j),
                       ("mu", mu_t, mu_j)):
        _close(a, b, 1e-10, name)
    k = te.DEFAULT_CONTACT.max_contacts
    assert (tg_t[:, 2 * k:3 * k] > 0).any()          # floor rows active
    assert (jf_t[:, 3 * k:] != 0).any()              # pair rows active


@pytest.mark.parametrize("r", [1, 3, 2])
def test_pd_control_step_matches_jax(world, r):
    spec, jm, tm, q, v, ctrl, (kp, kd, tl) = world
    pj = je.DEFAULT_CONTACT._replace(substep_resident=False, prep_refresh=r)
    step = jax.jit(jax.vmap(lambda a, b, c: je.pd_control_step(
        jm, a, b, c, jnp.asarray(kp), jnp.asarray(kd), jnp.asarray(tl), 15,
        pj)))
    qj, vj = step(jnp.asarray(q), jnp.asarray(v), jnp.asarray(ctrl))
    # a CPU batch dispatches to the plain split path
    pt = te.DEFAULT_CONTACT._replace(prep_refresh=r)
    qt, vt = te.pd_control_step(tm, torch.tensor(q), torch.tensor(v),
                                torch.tensor(ctrl), torch.tensor(kp),
                                torch.tensor(kd), torch.tensor(tl), 15, pt)
    _close(qt, qj, 1e-9, "qpos")
    _close(vt, vj, 1e-9, "qvel")


def test_torque_control_step_matches_jax(world):
    spec, jm, tm, q, v, _, (_, _, tl) = world
    # torques of up to ~1.5x the limit, so the clamp is exercised
    tau = np.random.RandomState(11).uniform(-1.5, 1.5, (B, spec.nu)) * tl
    step = jax.jit(jax.vmap(lambda a, b, c: je.torque_control_step(
        jm, a, b, c, jnp.asarray(tl), 15, je.DEFAULT_CONTACT)))
    qj, vj = step(jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau))
    qt, vt = te.torque_control_step(tm, torch.tensor(q), torch.tensor(v),
                                    torch.tensor(tau), torch.tensor(tl), 15,
                                    te.DEFAULT_CONTACT)
    assert torch.isfinite(qt).all() and torch.isfinite(vt).all()
    _close(qt, qj, 1e-9, "qpos")
    _close(vt, vj, 1e-9, "qvel")


def test_build_model_tables_match_jax(world):
    spec, jm, tm, *_ = world
    for name in ("nbody", "ndof", "nq", "nu", "ngeom", "ncpoint", "npair",
                 "nbpair", "parent", "dof_body", "actuator_dof"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert (tm.npair, tm.nbpair, tm.ncpoint) == (152, 34, 50)
    for name in ("anc_mask", "body_dof_mask", "body_desc_mask", "vp_mask",
                 "point_dof_mask", "cpoint_body", "cpoint_local",
                 "cpoint_radius", "cpoint_mu", "pair_body1", "pair_body2",
                 "pair_a1", "pair_b1", "pair_a2", "pair_b2", "pair_rsum",
                 "pair_rdiff", "pair_dof_mask", "bpair_body_seg",
                 "bpair_body_box", "bpair_a", "bpair_b", "bpair_rseg",
                 "bpair_boxpos", "bpair_boxquat", "bpair_half",
                 "bpair_dof_mask", "body_inertia", "dof_armature",
                 "jnt_range", "jnt_limited_f"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    for lvl, t in enumerate(tm.levels):
        n = t[0].shape[0]
        np.testing.assert_array_equal(t[0].numpy(),
                                      np.asarray(jm.level_body[lvl, :n]))
        np.testing.assert_array_equal(t[6].numpy(),
                                      np.asarray(jm.level_dof_idx[lvl, :n]))
        assert (np.asarray(jm.level_body[lvl, n:]) == jm.nbody).all()


def test_kernel_tables_match_ldl_lists(world):
    """The kernel's compressed-LDL ancestor lists equal ldl_pallas's and
    nest (the factorization's aligned prefix update relies on it)."""
    from egopose_tpu.physics.ldl_pallas import dof_anc_lists
    spec, jm, tm, *_ = world
    want = dof_anc_lists(np.asarray(jm.anc_mask))
    assert substep.dof_anc_lists(tm.anc_mask.numpy() > 0.5) == want
    dims, itab, ftab = substep.build_tables(tm, te.DEFAULT_CONTACT)
    assert dims["nnz"] == sum(len(a) for a in want)
    assert (dims["k"], dims["kp"], dims["c3"]) == (6, 6, 24)
    assert set(substep.DIM_FIELDS) - {"n_frames", "prep_refresh"} \
        == set(dims)
    assert itab.dtype == np.int32 and ftab.dtype == np.float64


def test_cuda_dispatch_refuses_unsupported_models(world):
    spec, jm, tm, *_ = world
    bad = tmodel.build_model(tparse(XML), dtype=torch.float64)
    object.__setattr__(bad, "actuator_dof", tuple(reversed(bad.actuator_dof)))
    assert substep.supports(tm) and not substep.supports(bad)
    with pytest.raises(NotImplementedError,
                       match="one actuator per hinge dof"):
        substep.build_tables(bad, te.DEFAULT_CONTACT)
