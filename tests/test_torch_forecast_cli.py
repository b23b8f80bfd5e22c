"""The ego-forecast eval chain of egopose_tpu_torch against the JAX
package's, float64 on the CPU, at a reduced synthetic size (2 takes x 40
frames, fr_margin 5, 10-step windows: 6 windows a take):

- the JAX ego_mimic_eval writes the estimation results;
- a JAX forecast agent writes the checkpoint (fresh weights, its ZFilter
  fed seeded observations);
- the JAX ego_forecast_eval and the port's run on it, initialised from the
  estimation results and with --gt-init: traj_pred and traj_orig agree to
  1e-8 (ten control steps of the same physics; the checkpoint's ZFilter is
  float64, so XLA's float32 sqrt does not enter), num_fail is equal, and
  the pickles have the same layout at the same path;
- eval_forecast of both packages gives equal horizon-30 / 90 metrics.

The config's state nets are ``id``: the JAX forecast eval cannot run an
LSTM state net in float64 (its carry starts in float32 and the scan
refuses the float64 carry it returns; ROADMAP §3).  The state LSTM's step
through a rollout is held in tests/test_torch_forecast.py."""
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8
M, TEST_LEN, N_TAKES, T_LEN = 5, 10, 2, 40
RESULT = os.path.join("results", "egoforecast", "tiny", "results",
                      "iter_0001_test%s.p")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(root):
    em = yaml.safe_load(open(f"{REPO}/config/egomimic/subject_03.yml"))
    ef = yaml.safe_load(open(f"{REPO}/config/egoforecast/subject_03_syn.yml"))
    for cfg in (em, ef):
        cfg.update(dict(fr_margin=M, env_episode_len=TEST_LEN, seed=3))
        for key in ("meta_id", "state_net_cfg", "state_net_iter"):
            cfg.pop(key, None)
    ef.update(dict(ego_mimic_cfg="tiny", ego_mimic_iter=0,
                   policy_s_net="id", value_s_net="id", policy_s_hdim=None,
                   value_s_hdim=None))
    for workload, cfg in (("egomimic", em), ("egoforecast", ef)):
        os.makedirs(os.path.join(root, "config", workload))
        with open(os.path.join(root, "config", workload, "tiny.yml"),
                  "w") as f:
            yaml.safe_dump(cfg, f)


class _In:
    """cwd = ``root`` and the reduced synthetic size, restored after."""

    def __init__(self, root):
        self.root = root
        self.env = {"EGOPOSE_SYNTHETIC_TAKES": str(N_TAKES),
                    "EGOPOSE_SYNTHETIC_LEN": str(T_LEN)}

    def __enter__(self):
        self.cwd = os.getcwd()
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        os.chdir(self.root)

    def __exit__(self, *exc):
        os.chdir(self.cwd)
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _jax_checkpoint(path):
    """A JAX forecast agent's checkpoint: fresh float64 weights, the
    ZFilter fed seeded observations.  (Saving needs no world: the agent
    is given the env params and the feature width only.)"""
    import jax.numpy as jnp
    from egopose_tpu.ops import running_norm as jrn
    from egopose_tpu.physics.spec import parse_mjcf
    from egopose_tpu.rl.agent_forecast import make_forecast_agent
    from egopose_tpu.utils.config import EgoForecastConfig, make_env_params
    cfg = EgoForecastConfig("tiny", create_dirs=True)
    spec = parse_mjcf(os.path.join(REPO, "assets", "mujoco_models",
                                   "humanoid_1205_v1.xml"))
    p = make_env_params(cfg, spec, obs_dim=115, dtype=np.float64)
    agent = make_forecast_agent(None, spec, p, None, None,
                                np.zeros((1, 1, 64)), cfg, batch_lanes=2,
                                seed=5, dtype=jnp.float64)
    obs = np.random.RandomState(7).randn(50, 115) * 0.5 + 0.2
    agent.zstat = jrn.push_batch(agent.zstat, jnp.asarray(obs))
    agent.save(path)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    from egopose_tpu.cli import ego_forecast_eval as jfe
    from egopose_tpu.cli import ego_mimic_eval as jme
    from egopose_tpu.cli import eval_forecast as jstats
    from egopose_tpu_torch.cli import ego_forecast_eval as tfe
    from egopose_tpu_torch.cli import eval_forecast as tstats
    roots = {who: str(tmp_path_factory.mktemp(who))
             for who in ("jax", "torch")}
    for root in roots.values():
        _configs(root)
    args = ["--cfg", "tiny", "--iter", "1", "--synthetic", "--f64",
            "--em-iter", "0"]
    stats = ["--egoforecast-cfg", "tiny", "--egoforecast-iter", "1"]
    with _In(roots["jax"]):
        jme.main(["--cfg", "tiny", "--iter", "0", "--synthetic", "--f64"])
        _jax_checkpoint(os.path.join("results", "egoforecast", "tiny",
                                     "models", "iter_0001.p"))
        jax_runs = {mode: jfe.main(args + extra)
                    for mode, extra in (("em", []), ("gt", ["--gt-init"]))}
        jax_stats = {mode: jstats.main(stats + extra) for mode, extra in
                     (("em", []), ("gt", ["--suffix", "_gt"]))}
    # the port reads the same estimation results and checkpoint
    for sub in (os.path.join("results", "egomimic", "tiny", "results"),
                os.path.join("results", "egoforecast", "tiny", "models")):
        os.makedirs(os.path.join(roots["torch"], sub))
        for name in os.listdir(os.path.join(roots["jax"], sub)):
            os.link(os.path.join(roots["jax"], sub, name),
                    os.path.join(roots["torch"], sub, name))
    with _In(roots["torch"]):
        torch_runs = {mode: tfe.main(args + extra + ["--device", "cpu"])
                      for mode, extra in (("em", []),
                                          ("gt", ["--gt-init"]))}
        torch_stats = {mode: tstats.main(stats + extra) for mode, extra in
                       (("em", []), ("gt", ["--suffix", "_gt"]))}
    return roots, jax_runs, torch_runs, jax_stats, torch_stats


@pytest.mark.parametrize("mode", ["em", "gt"])
def test_forecast_eval_matches_jax(chain, mode):
    roots, jax_runs, torch_runs, _, _ = chain
    (res_j, meta_j), (res_t, meta_t) = jax_runs[mode], torch_runs[mode]
    n_win = (T_LEN - TEST_LEN - M) // M + 1
    for key in ("traj_pred", "traj_orig"):
        assert sorted(res_t[key]) == sorted(res_j[key]) \
            == ["take_0", "take_1"]
        for take in res_j[key]:
            assert res_t[key][take].shape == (n_win, M + TEST_LEN, 59)
            np.testing.assert_allclose(res_t[key][take], res_j[key][take],
                                       rtol=0, atol=TOL, err_msg=key + take)
    assert meta_t["num_fail"] == meta_j["num_fail"]
    assert meta_t["algo"] == meta_j["algo"] == "ego_forecast"
    # the same pickle at the same path
    path = RESULT % ("_gt" if mode == "gt" else "")
    with open(os.path.join(roots["torch"], path), "rb") as f:
        saved_t, _ = pickle.load(f)
    with open(os.path.join(roots["jax"], path), "rb") as f:
        saved_j, _ = pickle.load(f)
    assert set(saved_t) == set(saved_j) == {"traj_pred", "traj_orig"}
    # em-init windows start from the estimate, --gt-init from the expert
    pred = res_t["traj_pred"]["take_0"]
    if mode == "gt":
        np.testing.assert_array_equal(pred[:, :M],
                                      res_t["traj_orig"]["take_0"][:, :M])
    else:
        assert np.abs(pred[1:, :M]
                      - res_t["traj_orig"]["take_0"][1:, :M]).max() > 1e-4


@pytest.mark.parametrize("mode", ["em", "gt"])
def test_forecast_stats_match_jax(chain, mode):
    roots, jax_runs, _, jax_stats, torch_stats = chain
    from egopose_tpu.cli.eval_forecast import compute_err_vs_h as jerr
    from egopose_tpu_torch.cli.eval_forecast import compute_err_vs_h as terr
    for horizon in ("horizon_30", "horizon_90"):
        np.testing.assert_allclose(torch_stats[mode][horizon],
                                   jax_stats[mode][horizon], rtol=0,
                                   atol=TOL, err_msg=horizon)
        assert np.isfinite(torch_stats[mode][horizon]).all()
    # on the same results the metrics are the same arithmetic
    res = jax_runs[mode][0]
    np.testing.assert_allclose(terr(res, "f", 30, M), jerr(res, "f", 30, M),
                               rtol=0, atol=1e-12)
