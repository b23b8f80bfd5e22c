"""The in-the-wild evaluation chain of egopose_tpu_torch against the JAX
package's, float64 on the CPU, at the size of tests/test_wild_eval.py
(fr_margin 5, episodes of 10, 16-wide features, two takes of 40 and 32
frames: the shorter one is a padded lane):

- ego_mimic_eval_wild of both packages on one JAX mimic checkpoint (fresh
  float64 weights, its ZFilter fed seeded observations, so XLA's float32
  sqrt does not enter): traj_pred and vel_pred per take within 1e-8, with
  the standing state prediction and re-anchored on a no_cnn state net the
  port writes in the JAX layout (its value fail-safe fires);
- eval_pose_wild of both packages on the same results, a statereg
  results pickle and a --meta-file with a tpv_offset, a tpv_flip and a
  traj_ub: the ego-mimic and statereg 2D metrics within 1e-5 relative
  (both build the metric's model in float32);
- ego_forecast_eval_wild of both packages on one JAX forecast checkpoint
  (``id`` state nets: the JAX f64 forecast eval cannot run an LSTM state
  net, ROADMAP §3) from the wild estimation: the windows within 1e-8, the
  same window count; the port once more with an LSTM state net in f64,
  finite;
- eval_forecast_wild at horizons 5 and 10 within 1e-5 relative;
- Pose2DContext against the JAX context on float64 models within 1e-10,
  flip both ways, and project_traj of T rows against T project_qpos calls;
- each wild CLI raises without CUDA (the vis flags run:
  tests/test_torch_cli_repairs.py).

The OpenPose keypoint files are the port's own float64 projections of a
moving standing pose (as tests/test_wild_eval.py writes them), with some
keypoints dropped to take the metric's other branches."""
import contextlib
import io
import json
import os
import pickle
import shutil
import types

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
TOL = 1e-8
REL = 1e-5
M, EP_LEN, FEAT_DIM = 5, 10, 16
TAKES = {"w01": 40, "w02": 32}
FEAT = "wild_01"
CPU = ["--device", "cpu"]
META = {"tpv_offset": {"w01": 3}, "tpv_flip": {"w02": True},
        "traj_ub": {"w01": 25}}


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
        cfg.update(dict(fr_margin=M, env_episode_len=EP_LEN, seed=1))
        for key in ("meta_id", "state_net_cfg", "state_net_iter"):
            cfg.pop(key, None)
    ef.update(dict(ego_mimic_cfg="tiny", ego_mimic_iter=1))
    ef_id = dict(ef, policy_s_net="id", value_s_net="id", policy_s_hdim=None,
                 value_s_hdim=None)
    sr = yaml.safe_load(open(f"{REPO}/config/statereg/subject_03.yml"))
    sr.update(v_hdim=8, cnn_fdim=FEAT_DIM, mlp_dim=[16], fr_margin=M)
    for workload, name, cfg in (
            ("egomimic", "tiny", em),
            ("egomimic", "tiny_sr", dict(em, state_net_cfg="sr_wild",
                                         state_net_iter=7)),
            ("egoforecast", "tiny", ef_id), ("egoforecast", "tiny_lstm", ef),
            ("statereg", "sr_wild", sr)):
        os.makedirs(os.path.join(root, "config", workload), exist_ok=True)
        with open(os.path.join(root, "config", workload, name + ".yml"),
                  "w") as f:
            yaml.safe_dump(cfg, f)


class _In:
    """cwd = ``root`` (restored after)."""

    def __init__(self, root):
        self.root = root

    def __enter__(self):
        self.cwd = os.getcwd()
        os.chdir(self.root)

    def __exit__(self, *exc):
        os.chdir(self.cwd)


def _context(dtype):
    from egopose_tpu_torch.physics.model import build_model
    from egopose_tpu_torch.physics.spec import parse_mjcf
    from egopose_tpu_torch.utils.pose2d import Pose2DContext
    spec = parse_mjcf(XML)
    return Pose2DContext(build_model(spec, dtype=dtype), spec)


def _standing(t_len, phase=0.0):
    """(t_len, nq) qpos of a standing pose whose joints sway."""
    q = np.zeros((t_len, 59))
    q[:, 2] = 0.9
    q[:, 3] = 1.0
    fr = np.arange(t_len)[:, None]
    q[:, 7:] = 0.02 * np.sin(0.3 * fr + phase + np.arange(52))
    return q


def _write_world(root):
    """The wild features (a bare dict), the keypoint files and the meta
    file; the keypoints drop the left arm every 4th frame and both hips
    every 7th (no valid ground truth there)."""
    rng = np.random.RandomState(0)
    feats = {take: rng.randn(n, FEAT_DIM).astype(np.float32)
             for take, n in TAKES.items()}
    os.makedirs(os.path.join(root, "datasets", "features"))
    with open(os.path.join(root, "datasets", "features",
                           f"cnn_feat_{FEAT}.p"), "wb") as f:
        pickle.dump(feats, f)
    from egopose_tpu_torch.utils.pose2d import JOINTS_MAP
    ctx = _context(torch.float64)
    for i, (take, n) in enumerate(TAKES.items()):
        pose_dir = os.path.join(root, "datasets", "tpv", "poses", take)
        os.makedirs(pose_dir)
        p2 = ctx.project_traj(_standing(n, i)) * 100.0 + 300.0
        for fr in range(n):
            kp = np.zeros(25 * 3)
            for op_idx, body in JOINTS_MAP:
                conf = 0.0 if (fr % 4 == 1 and body == "LeftArm") or \
                    (fr % 7 == 2 and body.endswith("UpLeg")) else 1.0
                row = p2[fr, ctx.body2id[body]]
                kp[3 * op_idx:3 * op_idx + 3] = [row[0], row[1], conf]
            with open(os.path.join(pose_dir, "%05d_keypoints.json" % fr),
                      "w") as f:
                json.dump({"people": [{"pose_keypoints_2d": kp.tolist()}]},
                          f)
    with open(os.path.join(root, "wild_meta.yml"), "w") as f:
        yaml.safe_dump(META, f)


def _jax_checkpoints(root):
    """The JAX mimic and forecast agents' checkpoints: fresh float64
    weights, each ZFilter fed seeded observations."""
    import jax.numpy as jnp
    from egopose_tpu.ops import running_norm as jrn
    from egopose_tpu.physics.spec import parse_mjcf
    from egopose_tpu.rl import AgentEgo
    from egopose_tpu.rl.agent_forecast import make_forecast_agent
    from egopose_tpu.utils.config import (EgoForecastConfig, EgoMimicConfig,
                                          make_env_params)
    spec = parse_mjcf(XML)
    feats = np.zeros((1, 1, FEAT_DIM))
    for seed, (cfg, make, workload) in enumerate((
            (EgoMimicConfig("tiny", create_dirs=True), AgentEgo, "egomimic"),
            (EgoForecastConfig("tiny", create_dirs=True), make_forecast_agent,
             "egoforecast"))):
        p = make_env_params(cfg, spec, obs_dim=115, dtype=np.float64)
        agent = make(None, spec, p, None, None, feats, cfg, batch_lanes=2,
                     seed=5 + seed, dtype=jnp.float64)
        obs = np.random.RandomState(7 + seed).randn(50, 115) * 0.5 + 0.2
        agent.zstat = jrn.push_batch(agent.zstat, jnp.asarray(obs))
        agent.save(os.path.join("results", workload, "tiny", "models",
                                "iter_0001.p"))
    # the re-anchored config evaluates the same mimic checkpoint
    os.makedirs(os.path.join("results", "egomimic", "tiny_sr"))
    os.symlink(os.path.abspath(os.path.join("results", "egomimic", "tiny",
                                            "models")),
               os.path.join("results", "egomimic", "tiny_sr", "models"))


def _state_net(root):
    """A no_cnn VideoRegNet over the 16 wild features with fresh weights,
    written by the port in the JAX layout as sr_wild's iter_0007_inf.p,
    its mean the standing pose and its std 0.01."""
    from egopose_tpu_torch.cli.state_reg import make_net
    from egopose_tpu_torch.convert import video_reg_net_to_jax
    from egopose_tpu_torch.utils.config import StateRegConfig
    net = make_net(StateRegConfig("sr_wild"), 115, True, (224, 224, 3),
                   seed=3)
    mean = np.zeros(115)
    mean[0], mean[1] = 0.9, 1.0
    models = os.path.join(root, "results", "statereg", "sr_wild", "models")
    os.makedirs(models)
    with open(os.path.join(models, "iter_0007_inf.p"), "wb") as f:
        pickle.dump(({"state_net_dict": video_reg_net_to_jax(
            net.state_dict())}, {"mean": mean, "std": np.full(115, 0.01),
                                 "cfg_id": "sr_wild"}), f)


def _statereg_results(root, em_results):
    """A statereg wild results pickle: the ego-mimic estimate, swayed."""
    path = os.path.join(root, "results", "statereg", "sr_wild", "results")
    os.makedirs(path)
    res = {"traj_pred": {t: a + 0.01 * np.sin(np.arange(a.size)).reshape(
        a.shape) for t, a in em_results["traj_pred"].items()}}
    with open(os.path.join(path, f"iter_0007_{FEAT}.p"), "wb") as f:
        pickle.dump((res, {"algo": "state_reg"}), f)


@pytest.fixture(scope="module")
def jit_jax_fk():
    """The JAX Pose2DContext's per-frame FK jitted (the same function;
    eager, each frame's FK takes ~0.7 s on the CPU)."""
    import jax
    from egopose_tpu.physics import engine
    from egopose_tpu.utils import pose2d
    mp = pytest.MonkeyPatch()
    mp.setattr(pose2d, "engine", types.SimpleNamespace(fk=jax.jit(engine.fk)))
    yield
    mp.undo()


def _quiet(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(args)
    return res, out.getvalue()


def _share(src, dst, sub):
    os.makedirs(os.path.join(dst, sub), exist_ok=True)
    for name in os.listdir(os.path.join(src, sub)):
        os.link(os.path.join(src, sub, name), os.path.join(dst, sub, name))


@pytest.fixture(scope="module")
def chain(tmp_path_factory, jit_jax_fk):
    from egopose_tpu.cli import ego_forecast_eval_wild as jfe
    from egopose_tpu.cli import ego_mimic_eval_wild as jme
    from egopose_tpu.cli import eval_forecast_wild as jfs
    from egopose_tpu.cli import eval_pose_wild as jps
    from egopose_tpu_torch.cli import ego_forecast_eval_wild as tfe
    from egopose_tpu_torch.cli import ego_mimic_eval_wild as tme
    from egopose_tpu_torch.cli import eval_forecast_wild as tfs
    from egopose_tpu_torch.cli import eval_pose_wild as tps
    roots = {who: str(tmp_path_factory.mktemp(who)) for who in ("jax",
                                                                 "torch")}
    for root in roots.values():
        with _In(root):
            _configs(root)
            _write_world(root)
            _state_net(root)
    mimic = ["--iter", "1", "--test-feat", FEAT, "--f64"]
    forecast = ["--cfg", "tiny", "--iter", "1", "--test-feat", FEAT,
                "--f64"]
    pose = ["--egomimic-cfg", "tiny", "--egomimic-iter", "1",
            "--statereg-cfg", "sr_wild", "--statereg-iter", "7", "--data",
            FEAT, "--meta-file", "wild_meta.yml"]
    fstats = ["--egoforecast-cfg", "tiny", "--egoforecast-iter", "1",
              "--data", FEAT, "--horizons", "5", str(EP_LEN), "--meta-file",
              "wild_meta.yml"]
    out = {"jax": {}, "torch": {}}
    with _In(roots["jax"]):
        _jax_checkpoints(roots["jax"])
        j = out["jax"]
        j["mimic_sr"] = jme.main(["--cfg", "tiny_sr"] + mimic)
        j["mimic"] = jme.main(["--cfg", "tiny"] + mimic)
        _statereg_results(roots["jax"], j["mimic"])
        j["pose"], j["pose_log"] = _quiet(jps.main, pose)
        j["forecast"] = jfe.main(forecast)
        j["fstats"], _ = _quiet(jfs.main, fstats)
    for sub in (os.path.join("results", "egomimic", "tiny", "models"),
                os.path.join("results", "egomimic", "tiny_sr", "models"),
                os.path.join("results", "egoforecast", "tiny", "models"),
                os.path.join("results", "statereg", "sr_wild", "results")):
        _share(roots["jax"], roots["torch"], sub)
    with _In(roots["torch"]):
        t = out["torch"]
        t["mimic_sr"], t["mimic_sr_meta"] = tme.main(["--cfg", "tiny_sr"]
                                                     + mimic + CPU)
        t["mimic"], t["mimic_meta"] = tme.main(["--cfg", "tiny"] + mimic
                                               + CPU)
        # the metrics and the forecast read the JAX estimation, as the
        # JAX CLIs do
        shutil.rmtree(os.path.join("results", "egomimic", "tiny",
                                   "results"))
        _share(roots["jax"], roots["torch"],
               os.path.join("results", "egomimic", "tiny", "results"))
        t["pose"], t["pose_log"] = _quiet(tps.main, pose + CPU)
        t["forecast"], t["forecast_meta"] = tfe.main(forecast + CPU)
        t["fstats"], _ = _quiet(tfs.main, fstats + CPU)
        t["forecast_lstm"], _ = tfe.main(["--cfg", "tiny_lstm"]
                                         + forecast[2:] + CPU)
    return roots, out


@pytest.mark.parametrize("run", ["mimic", "mimic_sr"])
def test_mimic_eval_wild_matches_jax(chain, run):
    _, out = chain
    res_j, res_t = out["jax"][run], out["torch"][run]
    meta_t = out["torch"][run + "_meta"]
    for key in ("traj_pred", "vel_pred"):
        assert list(res_t[key]) == list(res_j[key]) == list(TAKES)
        for take, n in TAKES.items():
            assert res_t[key][take].shape == (n - 2 * M,
                                              59 if key == "traj_pred"
                                              else 58)
            np.testing.assert_allclose(res_t[key][take], res_j[key][take],
                                       rtol=0, atol=TOL, err_msg=key + take)
    assert meta_t["algo"] == "ego_mimic" and meta_t["device"] == "cpu"
    assert meta_t["steps"] == max(TAKES.values()) - 2 * M
    if run == "mimic_sr":
        # the state net's fail-safe resets fired, so the [:, m:] indexing
        # of its predictions was read
        assert meta_t["num_reset"] > 0, meta_t
    with open(os.path.join(chain[0]["torch"], "results", "egomimic",
                           "tiny" if run == "mimic" else "tiny_sr",
                           "results", f"iter_0001_{FEAT}.p"), "rb") as f:
        saved, meta = pickle.load(f)
    assert set(saved) == {"traj_pred", "vel_pred"} and meta["algo"] \
        == "ego_mimic"


def test_pose_wild_metrics_match_jax(chain):
    _, out = chain
    for algo in ("ego_mimic", "state_reg"):
        got, want = out["torch"]["pose"][algo], out["jax"]["pose"][algo]
        assert np.isfinite(got).all() and got[0] > 0
        np.testing.assert_allclose(got, want, rtol=REL, atol=0,
                                   err_msg=algo)
    for line in ("w01 - pose dist", "w02 - pose dist", "all - pose dist"):
        assert out["torch"]["pose_log"].count(line) == 2


def test_forecast_eval_wild_matches_jax(chain):
    _, out = chain
    res_j, res_t = out["jax"]["forecast"], out["torch"]["forecast"]
    n_win = {"w01": 5, "w02": 3}
    assert out["torch"]["forecast_meta"]["n_windows"] == sum(n_win.values())
    assert list(res_t["traj_pred"]) == list(res_j["traj_pred"])
    for take, n in n_win.items():
        got = res_t["traj_pred"][take]
        assert got.shape == res_j["traj_pred"][take].shape \
            == (n, M + EP_LEN, 59)
        np.testing.assert_allclose(got, res_j["traj_pred"][take], rtol=0,
                                   atol=TOL, err_msg=take)
    lstm = out["torch"]["forecast_lstm"]
    for take, n in n_win.items():
        assert lstm["traj_pred"][take].shape == (n, M + EP_LEN, 59)
        assert np.isfinite(lstm["traj_pred"][take]).all()


def test_forecast_wild_metrics_match_jax(chain):
    _, out = chain
    assert sorted(out["torch"]["fstats"]) == [5, EP_LEN]
    for h in (5, EP_LEN):
        got, want = out["torch"]["fstats"][h], out["jax"]["fstats"][h]
        assert np.isfinite(got).all() and got[0] > 0
        np.testing.assert_allclose(got, want, rtol=REL, atol=0,
                                   err_msg=str(h))


@pytest.fixture(scope="module")
def contexts(jit_jax_fk):
    import jax.numpy as jnp
    from egopose_tpu.physics import build_model, parse_mjcf
    from egopose_tpu.utils.pose2d import Pose2DContext
    spec = parse_mjcf(XML)
    rng = np.random.RandomState(2)
    q = _standing(6)
    q[:, :3] += rng.randn(6, 3) * 0.3
    q[:, 3:7] = rng.randn(6, 4)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] += 0.3 * rng.randn(6, 52)
    return (Pose2DContext(build_model(spec, dtype=jnp.float64), spec),
            _context(torch.float64), q)


@pytest.mark.parametrize("flip", [False, True])
def test_pose2d_context_matches_jax(contexts, flip):
    jctx, tctx, q = contexts
    assert tctx.body_names == jctx.body_names
    assert tctx.joints_map == jctx.joints_map
    traj = tctx.project_traj(q, flip)
    gt = tctx.project_qpos(_standing(1)[0]) * 100.0 + 300.0
    gt = np.hstack([gt, np.ones((gt.shape[0], 1))])
    gt[tctx.body2id["LeftArm"], 2] = 0.0
    for i, row in enumerate(q):
        want = np.asarray(jctx.project_qpos(row, flip))
        np.testing.assert_allclose(tctx.project_qpos(row, flip), want,
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(traj[i], tctx.project_qpos(row, flip),
                                   rtol=0, atol=1e-12)
        got = tctx.align_qpos(row, gt, flip=flip)
        np.testing.assert_allclose(got, jctx.align_qpos(row, gt, flip=flip),
                                   rtol=0, atol=1e-10)
        np.testing.assert_array_equal(
            tctx.align_qpos(None, gt, p=traj[i]), got)
        assert abs(tctx.get_pose_dist(got, gt)
                   - jctx.get_pose_dist(got, gt)) <= 1e-10
    assert traj.shape == (len(q), tctx.nbody, 2)
    assert tctx.project_traj(q[:0]).shape == (0, tctx.nbody, 2)


CLI_ARGS = {
    "ego_mimic_eval_wild": ["--cfg", "tiny", "--iter", "1", "--test-feat",
                            FEAT],
    "eval_pose_wild": ["--egomimic-cfg", "tiny", "--egomimic-iter", "1",
                       "--data", FEAT],
    "ego_forecast_eval_wild": ["--cfg", "tiny", "--iter", "1",
                               "--test-feat", FEAT],
    "eval_forecast_wild": ["--egoforecast-cfg", "tiny",
                           "--egoforecast-iter", "1", "--data", FEAT]}


@pytest.mark.parametrize("cli", sorted(CLI_ARGS))
def test_cli_without_cuda_raises(chain, monkeypatch, cli):
    import importlib
    mod = importlib.import_module(f"egopose_tpu_torch.cli.{cli}")
    monkeypatch.chdir(chain[0]["torch"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(CLI_ARGS[cli])
