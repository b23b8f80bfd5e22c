"""The batched env of egopose_tpu_torch against the JAX env, float64 on
the CPU: from the same synthetic experts (same numpy stream) and fixed
expert/start indices with zero init noise, reset, several steps under the
same actions, and obs / reward / reward components / fail / done agree to
1e-8.  A diverged state trips finish_step's guard identically."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egopose_tpu import envs as jenvs
from egopose_tpu.physics import build_model as jbuild
from egopose_tpu.physics.spec import parse_mjcf as jparse
from egopose_tpu.utils import config as jcfg
from egopose_tpu_torch import envs as tenvs
from egopose_tpu_torch.physics import model as tmodel
from egopose_tpu_torch.physics.spec import parse_mjcf as tparse
from egopose_tpu_torch.utils import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
TOL = 1e-8
N_TAKES, T_LEN, N_STEPS = 2, 40, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores, and the port's small
    CPU tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    root = os.path.join(REPO, "config")
    jc = jcfg.EgoMimicConfig("subject_03", config_root=root)
    tc = tcfg.EgoMimicConfig("subject_03", config_root=root)
    jspec, tspec = jparse(XML), tparse(XML)
    jm = jbuild(jspec, dtype=jnp.float64)
    tm = tmodel.build_model(tspec, dtype=torch.float64)
    jp = jcfg.make_env_params(jc, jspec, obs_dim=115, dtype=np.float64)
    tp = tcfg.make_env_params(tc, tspec, obs_dim=115, dtype=torch.float64)
    jt, tt = jenvs.make_body_tables(jspec), tenvs.make_body_tables(tspec)
    je = jenvs.synthetic_experts(jm, jp, jt, jspec, N_TAKES, T_LEN, seed=1)
    te = tenvs.synthetic_experts(tm, tp, tt, tspec, N_TAKES, T_LEN, seed=1)
    return (jm, jp, jt, je), (tm, tp, tt, te)


def _close(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=TOL, err_msg=what)


def test_synthetic_experts_match(worlds):
    (_, _, _, je), (_, _, _, te) = worlds
    for name in je._fields:
        _close(getattr(te, name), getattr(je, name), name)


def test_reset_and_steps_match(worlds):
    (jm, jp, jt, je), (tm, tp, tt, te) = worlds
    start = 3
    ind = np.arange(N_TAKES)
    jreset = jax.vmap(lambda i: jenvs.reset(
        jm, jp, jt, je, jax.random.PRNGKey(0), fix_expert_ind=i,
        fix_start_ind=start))
    jst = jreset(jnp.asarray(ind))
    tst = tenvs.reset(tm, tp, tt, te, torch.Generator().manual_seed(0),
                      N_TAKES, fix_expert_ind=torch.tensor(ind),
                      fix_start_ind=start)
    for name in ("qpos", "qvel", "bquat", "cur_t", "expert_ind",
                 "start_ind"):
        _close(getattr(tst, name), getattr(jst, name), "reset " + name)
    _close(tenvs.observe(tp, tst), jax.vmap(
        lambda s: jenvs.observe(jp, s))(jst), "reset obs")

    jstep = jax.jit(jax.vmap(
        lambda s, a: jenvs.step(jm, jp, jt, je, s, a)))
    rng = np.random.RandomState(5)
    for k in range(N_STEPS):
        action = 0.2 * rng.randn(N_TAKES, 52)
        jst, jout = jstep(jst, jnp.asarray(action))
        tst, tout = tenvs.step(tm, tp, tt, te, tst, torch.tensor(action))
        for name in ("obs", "reward", "reward_info", "fail", "done", "end"):
            _close(getattr(tout, name), getattr(jout, name),
                   f"step {k} {name}")
        _close(tst.qpos, jst.qpos, f"step {k} qpos")
        assert ((tout.reward > 0) & (tout.reward <= 1)).all()


def test_divergence_guard_matches(worlds):
    (jm, jp, jt, je), (tm, tp, tt, te) = worlds
    jst = jax.vmap(lambda i: jenvs.reset(
        jm, jp, jt, je, jax.random.PRNGKey(0), fix_expert_ind=i,
        fix_start_ind=5))(jnp.arange(N_TAKES))
    tst = tenvs.reset(tm, tp, tt, te, torch.Generator().manual_seed(0),
                      N_TAKES, fix_expert_ind=torch.arange(N_TAKES),
                      fix_start_ind=5)
    qpos = np.asarray(jst.qpos).copy()
    qvel = np.asarray(jst.qvel).copy()
    qpos[0, 9] = np.nan                         # lane 0: non-finite state
    qvel[1, 12] = 3e8                           # lane 1: absurd velocity
    jnew, jout = jax.jit(jax.vmap(lambda s, a, b: jenvs.finish_step(
        jm, jp, jt, je, s, a, b)))(jst, jnp.asarray(qpos),
                                   jnp.asarray(qvel))
    tnew, tout = tenvs.finish_step(tm, tp, tt, te, tst, torch.tensor(qpos),
                                   torch.tensor(qvel))
    assert tout.fail.all() and tout.done.all()
    assert (tout.reward == 0).all() and torch.isfinite(tout.obs).all()
    _close(tnew.qpos, jnew.qpos, "guarded qpos")
    _close(tnew.qvel, jnew.qvel, "guarded qvel")
    for name in ("obs", "reward", "reward_info", "fail", "done"):
        _close(getattr(tout, name), getattr(jout, name), "guard " + name)


@pytest.fixture(scope="module")
def torque_worlds():
    """The worlds of ``worlds`` with action_type 'torque' and the config's
    j_stiff / j_damp override of every hinge dof (set_model_params), and
    the overridden specs."""
    root = os.path.join(REPO, "config")
    jc = jcfg.EgoMimicConfig("subject_03", config_root=root)
    tc = tcfg.EgoMimicConfig("subject_03", config_root=root)
    for c in (jc, tc):
        c.action_type = "torque"
        c.j_stiff, c.j_damp = 5.0, 20.0
    jspec = jcfg.apply_model_params(jparse(XML), jc)
    tspec = tcfg.apply_model_params(tparse(XML), tc)
    jm = jbuild(jspec, dtype=jnp.float64)
    tm = tmodel.build_model(tspec, dtype=torch.float64)
    jp = jcfg.make_env_params(jc, jspec, obs_dim=115, dtype=np.float64)
    tp = tcfg.make_env_params(tc, tspec, obs_dim=115, dtype=torch.float64)
    jt, tt = jenvs.make_body_tables(jspec), tenvs.make_body_tables(tspec)
    je = jenvs.synthetic_experts(jm, jp, jt, jspec, N_TAKES, T_LEN, seed=1)
    te = tenvs.synthetic_experts(tm, tp, tt, tspec, N_TAKES, T_LEN, seed=1)
    return (jm, jp, jt, je), (tm, tp, tt, te), (jspec, tspec)


def test_torque_mode_step_matches_jax(torque_worlds):
    """action_type 'torque' with the config's j_stiff / j_damp override of
    every hinge dof (set_model_params): the overridden models agree, and
    reset + steps under the same actions agree to 1e-8 (TOL), as in
    position mode; the physics itself is held to 1e-9 in
    test_torch_physics.py::test_torque_control_step_matches_jax."""
    (jm, jp, jt, je), (tm, tp, tt, te), (jspec, tspec) = torque_worlds
    assert (tspec.dof_stiffness[6:] == 5.0).all()
    assert (tspec.dof_damping[6:] == 20.0).all()
    np.testing.assert_array_equal(tspec.dof_damping, jspec.dof_damping)
    assert tp.action_type == jp.action_type == "torque"
    ind = np.arange(N_TAKES)
    jst = jax.vmap(lambda i: jenvs.reset(
        jm, jp, jt, je, jax.random.PRNGKey(0), fix_expert_ind=i,
        fix_start_ind=3))(jnp.asarray(ind))
    tst = tenvs.reset(tm, tp, tt, te, torch.Generator().manual_seed(0),
                      N_TAKES, fix_expert_ind=torch.tensor(ind),
                      fix_start_ind=3)
    jstep = jax.jit(jax.vmap(lambda s, a: jenvs.step(jm, jp, jt, je, s, a)))
    rng = np.random.RandomState(6)
    for k in range(2):
        # actions are torques through a_ref + action * a_scale
        action = 40.0 * rng.randn(N_TAKES, 52)
        jst, jout = jstep(jst, jnp.asarray(action))
        tst, tout = tenvs.step(tm, tp, tt, te, tst, torch.tensor(action))
        for name in ("obs", "reward", "reward_info", "fail", "done", "end"):
            _close(getattr(tout, name), getattr(jout, name),
                   f"step {k} {name}")
        _close(tst.qpos, jst.qpos, f"step {k} qpos")
        _close(tst.qvel, jst.qvel, f"step {k} qvel")
        assert torch.isfinite(tst.qpos).all()
