"""The port's ego-forecast CLIs on the CPU at a tiny size (4 lanes,
episodes of 8 steps, float64), in a temporary directory with the
committed ego-mimic iter_3000.p linked in:

- ego_forecast warm-starts from the mimic checkpoint (every policy and
  value leaf whose shape matches is the checkpoint's, the first layers'
  weights are not), trains one iteration and writes a checkpoint that the
  JAX forecast agent loads to equal network outputs (1e-12); a resume
  with --iter loads it back;
- ego_forecast_eval's --expert-ind / --start-ind restrict the windows as
  tests/test_forecast_eval_flags.py requires of the JAX CLI, and
  --show-noise moves the rollout off the mean actions;
- the options that are not ported raise, citing their ROADMAP item, and
  without CUDA the CLIs raise unless --device cpu is given."""
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIMIC = os.path.join(REPO, "results", "egomimic", "subject_03", "models")
TRAIN = ["--cfg", "tiny", "--synthetic", "--device", "cpu", "--f64",
         "--batch-lanes", "4", "--episode-len", "8", "--min-batch", "32"]
EVAL = ["--cfg", "tiny", "--iter", "1", "--synthetic", "--device", "cpu",
        "--f64", "--gt-init"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """cwd: config/egoforecast/tiny.yml (subject_03_syn with fr_margin 5,
    a checkpoint every iteration), the mimic config and models linked in;
    the synthetic world 2 takes x 40 frames."""
    root = tmp_path_factory.mktemp("forecast")
    cfg = yaml.safe_load(open(f"{REPO}/config/egoforecast/subject_03_syn.yml"))
    cfg.update(dict(fr_margin=5, env_episode_len=10, save_model_interval=1))
    cfg.pop("meta_id", None)
    os.makedirs(root / "config" / "egoforecast")
    yaml.safe_dump(cfg, open(root / "config" / "egoforecast" / "tiny.yml",
                             "w"))
    os.symlink(f"{REPO}/config/egomimic", root / "config" / "egomimic")
    os.makedirs(root / "results" / "egomimic" / "subject_03")
    os.symlink(MIMIC, root / "results" / "egomimic" / "subject_03" /
               "models")
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    mp.setenv("EGOPOSE_SYNTHETIC_TAKES", "2")
    mp.setenv("EGOPOSE_SYNTHETIC_LEN", "40")
    yield root
    mp.undo()


@pytest.fixture(scope="module")
def trained(workdir):
    from egopose_tpu_torch.cli import ego_forecast
    from egopose_tpu_torch.convert import load_checkpoint_pickle
    warm = ego_forecast.main(TRAIN + ["--max-iter", "0"])
    iters = []
    agent = ego_forecast.main(TRAIN + ["--max-iter", "1"],
                              iter_hook=lambda *a: iters.append(a))
    mimic = load_checkpoint_pickle(os.path.join(MIMIC, "iter_3000.p"))
    return warm, agent, iters, mimic


def test_warm_start_copies_the_mimic_leaves(trained):
    from egopose_tpu_torch.convert import params_to_jax
    warm, _, _, mimic = trained
    pol, _, val, _ = params_to_jax(*[n.state_dict() for n in warm.nets])
    for mine, theirs in ((pol, mimic["policy_dict"]),
                         (val, mimic["value_dict"])):
        mine, theirs = mine["params"], theirs["params"]
        for key, layer in theirs["net"].items():
            # the first layer's input differs (obs + 128 against 128 + 128)
            same = layer["kernel"].shape == mine["net"][key]["kernel"].shape
            assert same == (key != "Dense_0")
            if same:
                np.testing.assert_array_equal(mine["net"][key]["kernel"],
                                              layer["kernel"])
            np.testing.assert_array_equal(mine["net"][key]["bias"],
                                          layer["bias"])
        head = "action_mean" if "action_mean" in theirs else "value_head"
        np.testing.assert_array_equal(mine[head]["kernel"],
                                      theirs[head]["kernel"])


def test_cli_trains_and_jax_loads_its_checkpoint(trained):
    import jax.numpy as jnp
    from egopose_tpu.physics.spec import parse_mjcf
    from egopose_tpu.rl.agent_forecast import make_forecast_agent
    from egopose_tpu.utils.config import EgoForecastConfig, make_env_params
    _, agent, iters, _ = trained
    (i_iter, log, metrics, _), = iters
    assert i_iter == 0 and log.num_steps == 32
    assert np.isfinite([metrics["policy_loss"], metrics["value_loss"],
                        log.avg_c_reward]).all()
    path = os.path.join("results", "egoforecast", "tiny", "models",
                        "iter_0001.p")
    assert os.path.exists(path)

    cfg = EgoForecastConfig("tiny")
    spec = parse_mjcf(os.path.join(REPO, "assets", "mujoco_models",
                                   "humanoid_1205_v1.xml"))
    p = make_env_params(cfg, spec, obs_dim=115, dtype=np.float64)
    jagent = make_forecast_agent(None, spec, p, None, None,
                                 np.zeros((1, 1, 64)), cfg, batch_lanes=4,
                                 seed=9, dtype=jnp.float64)
    jagent.load(path)
    ts = jagent.train_state
    rng = np.random.RandomState(2)
    win, states = rng.randn(3, 5, 64), rng.randn(6, 3, 115)
    for jnet, jparams, vs, net in (
            (jagent.policy_vs_net, ts.policy_vs, agent.policy_vs_net,
             agent.policy_net),
            (jagent.value_vs_net, ts.value_vs, agent.value_vs_net,
             agent.value_net)):
        with torch.no_grad():
            ctx = vs.context(torch.tensor(win), torch.tensor(states))
        want = np.concatenate([
            np.broadcast_to(np.asarray(jnet.apply(
                jparams, jnp.asarray(win), method=jnet.encode_video))[None],
                (6, 3, 128)),
            np.asarray(jnet.apply(jparams, jnp.asarray(states),
                                  method=jnet.s_batch))], -1)
        np.testing.assert_allclose(ctx.numpy(), want, rtol=0, atol=1e-12)
        with torch.no_grad():
            out = net(ctx)
        jout = (jagent.policy_net if net is agent.policy_net
                else jagent.value_net).apply(
            ts.policy if net is agent.policy_net else ts.value,
            jnp.asarray(ctx.numpy()))
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        jout if isinstance(jout, tuple) else (jout,)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-12)
    np.testing.assert_array_equal(np.asarray(jagent.zstat.mean),
                                  agent.zstat.mean.numpy())


def test_cli_resumes_from_its_checkpoint(trained):
    from egopose_tpu_torch.cli import ego_forecast
    _, agent, _, _ = trained
    resumed = ego_forecast.main(TRAIN + ["--iter", "1", "--max-iter", "1"])
    for a, b in zip(agent.nets, resumed.nets):
        for x, y in zip(a.state_dict().values(), b.state_dict().values()):
            assert torch.equal(x, y)
    assert torch.equal(agent.zstat.mean, resumed.zstat.mean)


def test_eval_window_flags(trained):
    from egopose_tpu_torch.cli import ego_forecast_eval
    res_all, meta = ego_forecast_eval.main(EVAL)
    assert sorted(res_all["traj_pred"]) == ["take_0", "take_1"]
    assert meta["n_windows"] == 12
    res_one, _ = ego_forecast_eval.main(EVAL + ["--expert-ind", "1"])
    assert list(res_one["traj_pred"]) == ["take_1"]
    np.testing.assert_allclose(res_one["traj_pred"]["take_1"],
                               res_all["traj_pred"]["take_1"], atol=1e-5)
    res_win, _ = ego_forecast_eval.main(EVAL + ["--start-ind", "5"])
    for take in res_win["traj_pred"]:
        assert res_win["traj_pred"][take].shape[0] == 1
    res_noise, _ = ego_forecast_eval.main(EVAL + ["--show-noise"])
    a, b = res_noise["traj_pred"]["take_0"], res_all["traj_pred"]["take_0"]
    np.testing.assert_array_equal(a[:, :5], b[:, :5])
    assert np.abs(a[:, 5:] - b[:, 5:]).max() > 1e-6
    with pytest.raises(SystemExit):
        ego_forecast_eval.main(EVAL + ["--expert-ind", "7"])


@pytest.mark.parametrize("main, extra, item", [
    ("ego_forecast", ["--dp-devices", "2"], "item 5"),
    ("ego_forecast", ["--ckpt-format", "orbax"], "item 3")])
def test_cli_refuses_unported_options(workdir, main, extra, item):
    import importlib
    mod = importlib.import_module(f"egopose_tpu_torch.cli.{main}")
    args = ["--egoforecast-cfg", "tiny"] if main == "eval_forecast" \
        else ["--cfg", "tiny", "--synthetic", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=item):
        mod.main(args + extra)


def test_reference_format_mimic_checkpoint_is_refused(tmp_path,
                                                      monkeypatch):
    """Reference-format mimic checkpoints warm-start the forecast agent
    (tests/test_torch_refckpt.py); a truncated one, whose policy lacks its
    layers, is refused."""
    from egopose_tpu_torch.cli import ego_forecast
    from egopose_tpu_torch.convert import save_checkpoint_pickle
    os.makedirs(tmp_path / "config" / "egoforecast")
    cfg = yaml.safe_load(open(f"{REPO}/config/egoforecast/subject_03_syn.yml"))
    cfg.update(dict(ego_mimic_cfg="ref", ego_mimic_iter=1))
    cfg.pop("meta_id", None)
    yaml.safe_dump(cfg, open(tmp_path / "config" / "egoforecast" /
                             "tiny.yml", "w"))
    os.makedirs(tmp_path / "config" / "egomimic")
    shutil.copy(f"{REPO}/config/egomimic/subject_03.yml",
                tmp_path / "config" / "egomimic" / "ref.yml")
    os.makedirs(tmp_path / "results" / "egomimic" / "ref" / "models")
    save_checkpoint_pickle(
        str(tmp_path / "results" / "egomimic" / "ref" / "models" /
            "iter_0001.p"),
        {"policy_dict": {"net.0.weight": np.zeros((2, 2))}})
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_TAKES", "1")
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_LEN", "40")
    with pytest.raises(KeyError):
        ego_forecast.main(TRAIN + ["--max-iter", "0"])


@pytest.mark.parametrize("main", ["ego_forecast", "ego_forecast_eval"])
def test_cli_without_cuda_raises(workdir, monkeypatch, main):
    import importlib
    mod = importlib.import_module(f"egopose_tpu_torch.cli.{main}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--cfg", "tiny", "--synthetic"])
