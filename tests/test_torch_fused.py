"""The fused solver paths of egopose_tpu_torch against the JAX package, on
the CPU (where the port runs its kernels' plain versions):

- linalg.fused_contact_plain (K3's plain version) against JAX
  _fused_contact_single in float64 at 1e-10 and against the Pallas kernel
  _fused_contact_tpu in interpret mode in float32 at the JAX test's 2e-5
  (B=6, n=58, c=48, k=16, 25 iterations, as tests/test_fused_contact.py);
- linalg.pd_fused_plain (K4's) against _pd_fused_single in float64 at
  1e-10 and against _pd_fused_tpu in interpret mode in float32 at atol
  5e-5 / rtol 5e-4 (as tests/test_pd_fused.py);
- the engine paths on the humanoid in float64, B=3, 15 substeps, against
  the JAX engine: pd_control_step with pd_fused (qpos 1e-10, qvel 1e-9),
  the split path with fused_solver (prep refresh forced to 1), step_raw
  with fused_solver from a falling root, and the port's pd_fused path
  against its own split path at R=1;
- the slice: env steps (obs, reward, done) under pd_fused in position mode
  and under fused_solver in torque mode against the JAX env, from
  tests/test_torch_env.py's worlds, at its 1e-8;
- the CUDA wrappers refuse CPU tensors and sizes the kernels do not take
  (raised before any kernel is built).
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from egopose_tpu import envs as jenvs
from egopose_tpu.physics import build_model as jbuild, engine as je
from egopose_tpu.physics import linalg_pallas as LP
from egopose_tpu.physics.spec import parse_mjcf as jparse
from egopose_tpu_torch import envs as tenvs
from egopose_tpu_torch.physics import engine as te, linalg, model as tmodel
from egopose_tpu_torch.physics.spec import parse_mjcf as tparse
from test_torch_env import N_TAKES, TOL, torque_worlds, worlds  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
DT = 1.0 / 450


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what="", rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=tol, err_msg=what)


def _contact_inputs(seed):
    """tests/test_fused_contact.py's systems: B=6, n=58, c=48, k=16."""
    rng = np.random.RandomState(seed)
    b, n, c = 6, 58, 48
    x = rng.randn(b, n, n)
    a = np.einsum("bij,bkj->bik", x, x) + 10 * np.eye(n)
    return (a, rng.randn(b, n), rng.randn(b, n), rng.randn(b, c, n) * 0.3,
            np.abs(rng.randn(b, c)) * 0.1, np.ones((b, c // 3)))


def _pd_inputs(seed):
    """tests/test_pd_fused.py's systems: B=5, n=58, c=24, k=8."""
    rng = np.random.RandomState(seed)
    b, n, c, k = 5, 58, 24, 8
    x = rng.randn(b, n, n)
    mm = np.einsum("bij,bkj->bik", x, x) + 50 * np.eye(n)
    kdd = np.abs(rng.randn(b, n, 2))
    rhspd, e, jkp, jkd, qfb, qvel = (rng.randn(b, n) for _ in range(6))
    tlim, gear = np.abs(rng.randn(b, n)), np.abs(rng.randn(b, n))
    jf, target = rng.randn(b, c, n), rng.randn(b, c)
    mu = np.abs(rng.randn(b, k))
    return (mm, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, qvel, jf, target,
            mu)


@pytest.mark.parametrize("ref", ["single_f64", "kernel_interpret_f32"])
def test_fused_contact_plain_matches_jax(ref):
    args = _contact_inputs(0)
    if ref == "single_f64":
        want = jax.vmap(lambda *a: LP._fused_contact_single(
            *a, DT, 25, 1.0))(*map(jnp.asarray, args))
        got = linalg.fused_contact_plain(*map(torch.tensor, args), DT, 25,
                                         1.0)
        _close(got, want, 1e-10)
    else:
        f32 = [np.asarray(a, np.float32) for a in args]
        want = LP._fused_contact_tpu(*map(jnp.asarray, f32), DT, 25, 1.0,
                                     interpret=True)
        got = linalg.fused_contact_plain(*map(torch.tensor, f32), DT, 25,
                                         1.0)
        assert got.dtype == torch.float32
        _close(got, want, 2e-5)


@pytest.mark.parametrize("ref", ["single_f64", "kernel_interpret_f32"])
def test_pd_fused_plain_matches_jax(ref):
    args = _pd_inputs(1)
    if ref == "single_f64":
        want = jax.vmap(lambda *a: LP._pd_fused_single(*a, DT, 25, 1.0))(
            *map(jnp.asarray, args))
        got = linalg.pd_fused_plain(*map(torch.tensor, args), DT, 25, 1.0)
        _close(got, want, 1e-10)
    else:
        f32 = [np.asarray(a, np.float32) for a in args]
        want = LP._pd_fused_tpu(*map(jnp.asarray, f32), DT, 25, 1.0,
                                interpret=True)
        got = linalg.pd_fused_plain(*map(torch.tensor, f32), DT, 25, 1.0)
        assert got.dtype == torch.float32
        _close(got, want, 5e-5, rtol=5e-4)


# ---------------------------------------------------------------------------
# the engine paths on the humanoid
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def humanoid():
    """tests/test_pd_fused.py's states (B=3) with the config's gains."""
    spec = jparse(XML)
    jm = jbuild(spec, dtype=jnp.float64)
    tm = tmodel.build_model(tparse(XML), dtype=torch.float64)
    cfg = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                           "subject_03.yml")))
    jp = list(zip(*cfg["joint_params"]))
    gains = (np.array(jp[1], float) * cfg["jkp_multiplier"],
             np.array(jp[2], float) * cfg["jkp_multiplier"],
             np.array(jp[5], float))
    rng = np.random.RandomState(0)
    b = 3
    q = np.tile(np.concatenate([[0, 0, 0.85, 1, 0, 0, 0],
                                0.05 * rng.randn(52)]), (b, 1))
    q = q + 0.01 * rng.randn(b, 59)
    v = 0.1 * rng.randn(b, 58)
    ctrl = 0.1 * rng.randn(b, 52)
    return jm, tm, gains, (q, v, ctrl)


def _jax_pd_step(jm, gains, state, params):
    kp, kd, tl = map(jnp.asarray, gains)
    step = jax.jit(jax.vmap(lambda a, b, c: je.pd_control_step(
        jm, a, b, c, kp, kd, tl, 15, params)))
    return step(*map(jnp.asarray, state))


def _torch_pd_step(tm, gains, state, params, fn=te.pd_control_step):
    return fn(tm, *map(torch.tensor, state), *map(torch.tensor, gains), 15,
              params)


@pytest.mark.parametrize("option", ["pd_fused", "fused_solver"])
def test_pd_control_step_option_matches_jax(humanoid, option):
    """pd_fused (K4's path) and the split path with fused_solver (K3's,
    prep refresh forced to 1 whatever R asks) against the JAX engine."""
    jm, tm, gains, state = humanoid
    flags = {option: True}
    pj = je.DEFAULT_CONTACT._replace(substep_resident=False, **flags)
    pt = te.DEFAULT_CONTACT._replace(**flags)
    assert pt.prep_refresh == 3
    qj, vj = _jax_pd_step(jm, gains, state, pj)
    qt, vt = _torch_pd_step(tm, gains, state, pt)
    assert torch.isfinite(qt).all() and torch.isfinite(vt).all()
    _close(qt, qj, 1e-10, "qpos")
    _close(vt, vj, 1e-9, "qvel")


def test_pd_fused_matches_split_at_r1(humanoid):
    """The port's own pd_fused path against its split path at R=1 (the JAX
    test_pd_fused.py pair, at its 1e-10 / 1e-9)."""
    _, tm, gains, state = humanoid
    split = te.DEFAULT_CONTACT._replace(prep_refresh=1)
    qs, vs = _torch_pd_step(tm, gains, state, split,
                            te.pd_control_step_split)
    qf, vf = _torch_pd_step(tm, gains, state, split._replace(pd_fused=True))
    _close(qf, qs.numpy(), 1e-10, "qpos")
    _close(vf, vs.numpy(), 1e-9, "qvel")


def test_step_raw_fused_solver_matches_jax(humanoid):
    """step_raw with fused_solver from tests/test_fused_contact.py's
    falling-root state (root at 0.86 m, falling at 0.5 m/s), 15 substeps."""
    jm, tm, _, _ = humanoid
    q = np.zeros((3, 59))
    q[:, 2], q[:, 3] = 0.86, 1.0
    q[1:, 7:] = 0.05 * np.random.RandomState(2).randn(2, 52)
    v = np.zeros((3, 58))
    v[:, 2] = -0.5
    tau = np.zeros((3, 58))
    pj = je.DEFAULT_CONTACT._replace(substep_resident=False,
                                     fused_solver=True)
    pt = te.DEFAULT_CONTACT._replace(fused_solver=True)

    def jsteps(a, b, c):
        return jax.lax.fori_loop(
            0, 15, lambda _, s: je.step_raw(jm, *s, c, pj), (a, b))
    qj, vj = jax.jit(jax.vmap(jsteps))(*map(jnp.asarray, (q, v, tau)))
    qt, vt = torch.tensor(q), torch.tensor(v)
    for _ in range(15):
        qt, vt = te.step_raw(tm, qt, vt, torch.tensor(tau), pt)
    _close(qt, qj, 1e-10, "qpos")
    _close(vt, vj, 1e-9, "qvel")


# ---------------------------------------------------------------------------
# the slice: env steps under the fused options
# ---------------------------------------------------------------------------

def _env_steps_match(jw, tw, option, n_steps, scale, seed):
    """reset + n_steps env steps under ``option`` in both packages' env
    params; obs, reward, reward_info, fail, done, end and the state agree
    to TOL (1e-8)."""
    (jm, jp, jt, je_), (tm, tp, tt, te_) = jw, tw
    jp = dataclasses.replace(jp, contact=jp.contact._replace(
        substep_resident=False, **{option: True}))
    tp = dataclasses.replace(tp, contact=tp.contact._replace(
        **{option: True}))
    ind = np.arange(N_TAKES)
    jst = jax.vmap(lambda i: jenvs.reset(
        jm, jp, jt, je_, jax.random.PRNGKey(0), fix_expert_ind=i,
        fix_start_ind=3))(jnp.asarray(ind))
    tst = tenvs.reset(tm, tp, tt, te_, torch.Generator().manual_seed(0),
                      N_TAKES, fix_expert_ind=torch.tensor(ind),
                      fix_start_ind=3)
    jstep = jax.jit(jax.vmap(lambda s, a: jenvs.step(jm, jp, jt, je_, s, a)))
    rng = np.random.RandomState(seed)
    for k in range(n_steps):
        action = scale * rng.randn(N_TAKES, 52)
        jst, jout = jstep(jst, jnp.asarray(action))
        tst, tout = tenvs.step(tm, tp, tt, te_, tst, torch.tensor(action))
        for name in ("obs", "reward", "reward_info", "fail", "done", "end"):
            _close(getattr(tout, name), getattr(jout, name), TOL,
                   f"step {k} {name}")
        _close(tst.qpos, jst.qpos, TOL, f"step {k} qpos")
        _close(tst.qvel, jst.qvel, TOL, f"step {k} qvel")
        assert ((tout.reward > 0) & (tout.reward <= 1)).all()


def test_env_steps_pd_fused_match_jax(worlds):
    _env_steps_match(*worlds, "pd_fused", n_steps=3, scale=0.2, seed=5)


def test_env_steps_torque_fused_solver_match_jax(torque_worlds):
    _env_steps_match(*torque_worlds[:2], "fused_solver", n_steps=2,
                     scale=40.0, seed=6)


# ---------------------------------------------------------------------------
# the CUDA wrappers' argument checks (before any build)
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    a, qfrc, qvel, jf, target, mu = map(
        torch.tensor, [np.asarray(x, np.float32) for x in _contact_inputs(3)])
    with pytest.raises(ValueError, match="CUDA"):
        linalg.fused_contact_cuda(a, qfrc, qvel, jf, target, mu, DT, 10, 1.0)
    with pytest.raises(ValueError, match="c >= 3k"):
        linalg.fused_contact_cuda(a, qfrc, qvel, jf[:, :20], target[:, :20],
                                  mu, DT, 10, 1.0)
    pd = [torch.tensor(np.asarray(x, np.float32)) for x in _pd_inputs(4)]
    with pytest.raises(ValueError, match="CUDA"):
        linalg.pd_fused_cuda(*pd, DT, 10, 1.0)
    with pytest.raises(ValueError, match="unsupported dtype"):
        linalg.pd_fused_cuda(*[x.half() for x in pd], DT, 10, 1.0)
