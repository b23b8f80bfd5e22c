"""The MuJoCo C oracle of egopose_tpu_torch (``envs/mujoco_oracle.py``,
``ego_mimic_eval --engine mujoco``) against the JAX package's, on the CPU:

- the MJCF both oracles load is the same string, and
  ``MuJoCoOracle.control_step`` of both packages from the same seeded
  states and controls, float64, agrees within 1e-12 (both run the same
  MuJoCo C and scipy); the port's also takes torch tensors;
- closed loop on the tiny world of tests/test_cross_engine.py (fr_margin
  5, episodes of 10, 2 synthetic takes x 40 frames, iter 0: a JAX agent's
  fresh float64 weights written as iter_0000.p, its ZFilter fed seeded
  observations), ``--engine mujoco --f64`` of both packages: the same
  num_reset, traj_pred within 1e-6 (tests/test_torch_eval.py's bar), the
  ``_mj`` pickle written with meta["engine"];
- the trained-policy band (slow): the committed iter_0800.p on the
  --synthetic world under the port's --engine mujoco and --engine torch,
  pose_dist within 5% and num_reset within max(20%, 3), the band of
  tests/test_cross_engine.py.

Outputs go to temporary directories; nothing outside the repository is
read.
"""
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
MJ_PATH = os.path.join("results", "egomimic", "tiny_xe", "results",
                       "iter_0000_test_mj.p")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gains():
    cfg = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                           "subject_03.yml")))
    jp = list(zip(*cfg["joint_params"]))
    mult = cfg.get("jkp_multiplier", 1.0)
    return (np.array(jp[1], float) * mult, np.array(jp[2], float) * mult,
            np.array(jp[5], float))


def _states(n, seed):
    """Seeded standing states with joint and root noise, and controls."""
    rng = np.random.RandomState(seed)
    q = np.zeros((n, 59))
    q[:, 2] = 0.95
    q[:, 3] = 1.0
    q[:, :3] += 0.02 * rng.randn(n, 3)
    q[:, 7:] = 0.2 * rng.randn(n, 52)
    v = 0.3 * rng.randn(n, 58)
    ctrl = 0.3 * rng.randn(n, 52)
    return q, v, ctrl


@pytest.fixture(scope="module")
def oracles():
    from egopose_tpu.envs.mujoco_oracle import MuJoCoOracle as JOracle
    from egopose_tpu.physics import parse_mjcf as jparse
    from egopose_tpu_torch.envs.mujoco_oracle import MuJoCoOracle
    from egopose_tpu_torch.physics.spec import parse_mjcf
    jkp, jkd, tl = _gains()
    return (JOracle(jparse(XML), 3, jkp, jkd, tl),
            MuJoCoOracle(parse_mjcf(XML), 3, jkp, jkd, tl))


def test_oracle_loads_the_same_mjcf():
    from egopose_tpu.physics import export_mjcf as jexport
    from egopose_tpu.physics import parse_mjcf as jparse
    from egopose_tpu_torch.physics.spec import export_mjcf, parse_mjcf
    assert export_mjcf(parse_mjcf(XML)) == jexport(jparse(XML))


@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_control_step_matches_jax(oracles, seed):
    joracle, oracle = oracles
    q, v, ctrl = _states(3, seed)
    jq, jv, tq, tv = q, v, q, v
    for _ in range(3):                 # the warm start carries over
        jq, jv = joracle.control_step(jq, jv, ctrl)
        tq, tv = oracle.control_step(tq, tv, ctrl)
        assert tq.dtype == np.float64 and np.isfinite(tq).all()
        np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-12)
    assert np.abs(tq - q).max() > 1e-3              # it moved


def test_oracle_takes_tensors():
    """control_step on float32 torch tensors equals it on the float64
    arrays of their values, each from a fresh oracle's warm start."""
    from egopose_tpu_torch.envs.mujoco_oracle import MuJoCoOracle
    from egopose_tpu_torch.physics.spec import parse_mjcf
    q, v, ctrl = (torch.tensor(x, dtype=torch.float32)
                  for x in _states(3, 2))
    fresh = lambda: MuJoCoOracle(parse_mjcf(XML), 3, *_gains())
    got = fresh().control_step(q, v, ctrl)
    want = fresh().control_step(*(x.double().numpy() for x in (q, v, ctrl)))
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)


def _tiny_world(root):
    """config/egomimic/tiny_xe.yml (tests/test_cross_engine.py's tiny
    config) and a JAX agent's fresh float64 weights as its iter_0000.p."""
    import jax.numpy as jnp
    from egopose_tpu.ops import running_norm as jrn
    from egopose_tpu.physics.spec import parse_mjcf
    from egopose_tpu.rl import AgentEgo
    from egopose_tpu.utils.config import EgoMimicConfig, make_env_params
    em = yaml.safe_load(open(f"{REPO}/config/egomimic/subject_03.yml"))
    em.update(dict(fr_margin=5, env_episode_len=10, seed=3))
    for key in ("meta_id", "state_net_cfg", "state_net_iter"):
        em.pop(key, None)
    os.makedirs(os.path.join(root, "config", "egomimic"))
    with open(os.path.join(root, "config", "egomimic", "tiny_xe.yml"),
              "w") as f:
        yaml.safe_dump(em, f)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        cfg = EgoMimicConfig("tiny_xe", create_dirs=True)
        spec = parse_mjcf(XML)
        p = make_env_params(cfg, spec, obs_dim=115, dtype=np.float64)
        agent = AgentEgo(None, spec, p, None, None, np.zeros((1, 1, 64)),
                         cfg, batch_lanes=2, seed=5, dtype=jnp.float64)
        obs = np.random.RandomState(7).randn(50, 115) * 0.5 + 0.2
        agent.zstat = jrn.push_batch(agent.zstat, jnp.asarray(obs))
        agent.save(os.path.join(cfg.model_dir, "iter_0000.p"))
    finally:
        os.chdir(cwd)


def _in(root, fn):
    """``fn()`` with cwd = root and 2 synthetic takes x 40 frames, then the
    _mj pickle it wrote; cwd and the environment restored after."""
    env = {"EGOPOSE_SYNTHETIC_TAKES": "2", "EGOPOSE_SYNTHETIC_LEN": "40"}
    saved = {k: os.environ.get(k) for k in env}
    cwd = os.getcwd()
    os.environ.update(env)
    os.chdir(root)
    try:
        out = fn()
        with open(MJ_PATH, "rb") as f:
            return out, pickle.load(f)
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def closed_loop(tmp_path_factory):
    import jax
    from egopose_tpu import envs as jenvs
    from egopose_tpu.cli import ego_mimic_eval as jeval
    from egopose_tpu_torch.cli import ego_mimic_eval as teval
    root = str(tmp_path_factory.mktemp("xe"))
    _tiny_world(root)
    args = ["--cfg", "tiny_xe", "--iter", "0", "--synthetic", "--f64",
            "--engine", "mujoco"]
    # the JAX oracle loop runs its step eagerly; its post-physics half
    # jitted (the same function) takes ~3 s a step off the CPU run
    mp = pytest.MonkeyPatch()
    mp.setattr(jenvs, "finish_step", jax.jit(
        jenvs.finish_step, static_argnames=("fix_len", "fix_head_lb")))
    try:
        jax_run = _in(root, lambda: jeval.main(args))
    finally:
        mp.undo()
    torch_run = _in(root, lambda: teval.main(args + ["--device", "cpu"]))
    return jax_run, torch_run


def test_closed_loop_matches_jax(closed_loop):
    ((res_j, meta_j), _), ((res_t, meta_t), _) = closed_loop
    assert sorted(res_t["traj_pred"]) == sorted(res_j["traj_pred"])
    for take in res_j["traj_pred"]:
        assert res_t["traj_pred"][take].shape == (30, 59)
        np.testing.assert_allclose(res_t["traj_pred"][take],
                                   res_j["traj_pred"][take], rtol=0,
                                   atol=1e-6, err_msg=take)
        np.testing.assert_allclose(res_t["vel_pred"][take],
                                   res_j["vel_pred"][take], rtol=0,
                                   atol=1e-6, err_msg=take)
    assert meta_t["num_reset"] == meta_j["num_reset"]
    assert meta_t["num_reset"] > 0        # the fail-safe took its branch


def test_closed_loop_writes_mj_pickle(closed_loop):
    ((res_t, meta_t), (saved, meta)) = closed_loop[1]
    assert meta["engine"] == meta_t["engine"] == "mujoco"
    assert meta["num_reset"] == meta_t["num_reset"]
    assert set(saved) == {"traj_pred", "traj_orig", "vel_pred"}
    for take, traj in res_t["traj_pred"].items():
        np.testing.assert_array_equal(saved["traj_pred"][take], traj)


def test_mujoco_engine_launches_no_kernel(tmp_path, monkeypatch):
    """Under --engine mujoco the port's engine never steps: its control
    step (K1 on the card) is not called."""
    from egopose_tpu_torch.cli import ego_mimic_eval
    from egopose_tpu_torch.physics import engine
    calls = []
    monkeypatch.setattr(engine, "pd_control_step",
                        lambda *a, **k: calls.append(1))
    _tiny_world(str(tmp_path))
    env = {"EGOPOSE_SYNTHETIC_TAKES": "2", "EGOPOSE_SYNTHETIC_LEN": "14"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    res, meta = ego_mimic_eval.main(
        ["--cfg", "tiny_xe", "--iter", "0", "--synthetic", "--f64",
         "--engine", "mujoco", "--device", "cpu"])
    assert not calls and meta["steps"] == 4
    assert all(np.isfinite(t).all() for t in res["traj_pred"].values())


@pytest.mark.slow
def test_trained_policy_band(tmp_path, monkeypatch):
    """The committed iter_0800.p on the --synthetic world (4 takes x 400
    frames): the port's --engine mujoco against its --engine torch,
    pose_dist within 5% and num_reset within max(20%, 3)."""
    from egopose_tpu_torch.cli import ego_mimic_eval
    from egopose_tpu_torch.cli.eval_pose import compute_stats
    models = tmp_path / "results" / "egomimic" / "subject_03"
    models.mkdir(parents=True)
    os.symlink(os.path.join(REPO, "config"), tmp_path / "config")
    os.symlink(os.path.join(REPO, "results", "egomimic", "subject_03",
                            "models"), models / "models")
    monkeypatch.chdir(tmp_path)
    args = ["--cfg", "subject_03", "--synthetic", "--iter", "800",
            "--device", "cpu"]
    res_t, meta_t = ego_mimic_eval.main(args)
    res_m, meta_m = ego_mimic_eval.main(args + ["--engine", "mujoco"])
    s_t, s_m = compute_stats(res_t), compute_stats(res_m)
    n_t, n_m = meta_t["num_reset"], meta_m["num_reset"]
    assert n_t < 400 and n_m < 400, (n_t, n_m)     # the policy walks
    rel = abs(s_t["pose_dist"] - s_m["pose_dist"]) / s_m["pose_dist"]
    assert rel < 0.05, (s_t["pose_dist"], s_m["pose_dist"])
    assert abs(n_t - n_m) <= max(0.2 * max(n_t, n_m), 3.0), (n_t, n_m)
