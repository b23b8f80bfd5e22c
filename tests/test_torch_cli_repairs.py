"""The port's CLI surface against the JAX package's, on the CPU:

- every console script's twin takes the JAX CLI's flags, and adds none
  but ``--device``;
- eval_pose scores a state-regression results pickle (``--algo state_reg
  --statereg-cfg --statereg-iter``: results/statereg/<cfg>/results/
  iter_%04d_<data><tag>.p) and an ego-mimic one as the JAX CLI does, within
  1e-12, with the vis flags given;
- eval_pose and eval_forecast parse ``--multi``, ``--vis-model`` and
  ``--multi-vis-model``;
- the parallel runtime's options (ROADMAP §1 item 5: ``--dp-devices`` of
  ego_mimic, ego_forecast and state_reg, ``--sp-devices`` of ego_mimic and
  ego_mimic_eval, and ``--render`` under ``--dp-devices``) run on 2 gloo
  ranks at a tiny size and write their artifact: the checkpoint (a TCN
  config under ``--sp-devices``), the eval's results pickle, equal to the
  one-process eval's, or the render sample, equal to the one-process
  sample;
- every option that ROADMAP §1 items 2-4 lifted (``--engine mujoco``,
  ``--profile-dir``, ``--render`` and the vis modes and flags of the ten
  eval and training CLIs; ``--ckpt-format orbax``, the a2c and trpo
  objectives and the discriminator block of the training CLIs) runs on the
  CPU at a tiny size and writes its artifact: a trace.json with the
  loop's spans and a setup_trace.json with the set-up's, a render or
  replay npz, the ``_mj``
  pickle, the vis fallback's npz or the wild composited videos, the native
  checkpoint that a second run resumes with equal nets and optimizers, a
  log with ``discrim_loss``, or an agent trained under the objective.
"""
import argparse
import glob
import importlib
import json
import os
import pickle
import re

import numpy as np
import pytest
import yaml

from test_data_pipeline import _make_traj
from test_torch_checkpoint import _assert_equal_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "egopose_tpu",
                                                     "cli"))
              if f.endswith(".py") and not f.startswith("_"))
TOL = 1e-12


class _Parsed(Exception):
    pass


def parser_of(module):
    """The argparse parser that ``module.main`` builds (captured when it
    parses, before main does anything else)."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, *args, **kw):
        seen["parser"] = self
        raise _Parsed

    argparse.ArgumentParser.parse_args = capture
    try:
        importlib.import_module(module).main([])
    except _Parsed:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["parser"]


def flags(module):
    return {s for s in parser_of(module)._option_string_actions
            if s not in ("-h", "--help")}


def test_every_console_script_has_a_twin():
    assert len(CLIS) == 15
    assert all(os.path.exists(os.path.join(REPO, "egopose_tpu_torch", "cli",
                                           f"{c}.py")) for c in CLIS)


@pytest.mark.parametrize("cli", CLIS)
def test_cli_flags_match_jax(cli):
    jax_flags = flags(f"egopose_tpu.cli.{cli}")
    port = flags(f"egopose_tpu_torch.cli.{cli}")
    assert jax_flags <= port
    assert port - jax_flags <= {"--device"}


@pytest.mark.parametrize("cli", ["eval_pose", "eval_forecast"])
def test_vis_flags_parse(cli):
    parser = parser_of(f"egopose_tpu_torch.cli.{cli}")
    jparser = parser_of(f"egopose_tpu.cli.{cli}")
    argv = ["--multi", "--vis-model", "a", "--multi-vis-model", "b"]
    args = parser.parse_args(argv)
    assert (args.multi, args.vis_model, args.multi_vis_model) \
        == (True, "a", "b")
    defaults, jdefaults = parser.parse_args([]), jparser.parse_args([])
    for key in ("multi", "vis_model", "multi_vis_model"):
        assert getattr(defaults, key) == getattr(jdefaults, key)


def _results(seed):
    """A results pickle's (results, meta): two takes of a standing pose's
    trajectory (tests/test_data_pipeline.py) and a noisy estimate of it."""
    rng = np.random.RandomState(seed)
    orig = {f"take_{i}": _make_traj(seed + i) for i in range(2)}
    pred = {k: v + 0.02 * rng.randn(*v.shape) for k, v in orig.items()}
    pred["take_1"] = pred["take_1"][:-5]       # a shorter estimate
    return {"traj_pred": pred, "traj_orig": orig}, {"algo": "x", "steps": 3}


@pytest.mark.parametrize("algo", ["state_reg", "ego_mimic"])
def test_eval_pose_matches_jax(tmp_path, monkeypatch, algo):
    from egopose_tpu.cli import eval_pose as jeval
    from egopose_tpu_torch.cli import eval_pose
    monkeypatch.chdir(tmp_path)
    if algo == "state_reg":
        path = "results/statereg/sr_cfg/results/iter_0004_test_x.p"
        argv = ["--algo", "state_reg", "--statereg-cfg", "sr_cfg",
                "--statereg-iter", "4", "--tag", "_x"]
    else:
        path = "results/egomimic/em_cfg/results/iter_0030_test.p"
        argv = ["--egomimic-cfg", "em_cfg", "--egomimic-iter", "30"]
    os.makedirs(os.path.dirname(path))
    with open(path, "wb") as f:
        pickle.dump(_results(3), f)
    got = eval_pose.main(argv + ["--multi", "--vis-model", "v"])
    want = jeval.main(argv)
    assert sorted(got["per_take"]) == ["take_0", "take_1"]
    for key in ("pose_dist", "vel_dist", "accel"):
        assert np.isfinite(got[key]) and got[key] > 0
        assert abs(got[key] - want[key]) <= TOL * max(1.0, abs(want[key]))
        for take in got["per_take"]:
            assert abs(got["per_take"][take][key]
                       - want["per_take"][take][key]) <= TOL * max(
                1.0, abs(want["per_take"][take][key]))


# ---------------------------------------------------------------------------
# The options ROADMAP §1 item 2 lifted: each runs and writes its artifact
# ---------------------------------------------------------------------------

WILD = "wild"
TINY_TAKES, TINY_LEN, TINY_M, TINY_EP = 2, 30, 5, 10


# the training configs' variants, tiny_<name>.yml (disc: ego-mimic only)
VARIANTS = {"save": {"save_model_interval": 2},
            "trpo": {"policy_objective": "trpo"},
            "a2c": {"policy_objective": "a2c"},
            "disc": {"discriminator": {"hidden_dims": [16], "num_update": 2,
                                       "reward_weight": 0.5}},
            "tcn": {"save_model_interval": 2,
                    **{f"{who}_v_{key}": value for who in ("policy", "value")
                       for key, value in (("net", "tcn"), ("net_param", {
                           "size": [16, 128], "dropout": 0.0}))}}}


def _tiny_configs(root):
    """config/egomimic/tiny.yml and config/egoforecast/tiny.yml: the
    shipped configs at fr_margin 5, episodes of 10 and one optimizer epoch
    (the profiler records every host op of the update); and their
    VARIANTS.  config/statereg/tiny.yml: subject_03 at the JAX mesh test's
    widths, chunks of 24 frames, a checkpoint every epoch."""
    em = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                          "subject_03.yml")))
    ef = yaml.safe_load(open(os.path.join(REPO, "config", "egoforecast",
                                          "subject_03_syn.yml")))
    for cfg in (em, ef):
        cfg.update(fr_margin=TINY_M, env_episode_len=TINY_EP, seed=1,
                   num_optim_epoch=1)
        for key in ("meta_id", "state_net_cfg", "state_net_iter"):
            cfg.pop(key, None)
    ef.update(ego_mimic_cfg="tiny", ego_mimic_iter=0)
    sr = yaml.safe_load(open(os.path.join(REPO, "config", "statereg",
                                          "subject_03.yml")))
    sr.update(fr_num=24, fr_margin=3, v_hdim=16, cnn_fdim=12, mlp_dim=[24],
              save_model_interval=1, seed=5)
    sr.pop("meta_id", None)
    os.makedirs(os.path.join(root, "config", "statereg"))
    with open(os.path.join(root, "config", "statereg", "tiny.yml"), "w") as f:
        yaml.safe_dump(sr, f)
    for workload, cfg in (("egomimic", em), ("egoforecast", ef)):
        os.makedirs(os.path.join(root, "config", workload))
        for name, extra in [("tiny", {})] + [
                ("tiny_" + k, v) for k, v in VARIANTS.items()
                if k != "disc" or workload == "egomimic"]:
            with open(os.path.join(root, "config", workload, name + ".yml"),
                      "w") as f:
                yaml.safe_dump({**cfg, **extra}, f)


@pytest.fixture(scope="module")
def tiny_world(tmp_path_factory):
    """Configs, wild features and the results pickles the metric CLIs
    read: ego-mimic (test and wild, with vel_pred) and ego-forecast
    windows (test and wild), each a standing pose's trajectory
    (tests/test_data_pipeline.py)."""
    root = str(tmp_path_factory.mktemp("tiny"))
    _tiny_configs(root)
    rng = np.random.RandomState(0)
    takes = [f"take_{i}" for i in range(TINY_TAKES)]
    os.makedirs(os.path.join(root, "datasets", "features"))
    with open(os.path.join(root, "datasets", "features",
                           f"cnn_feat_{WILD}.p"), "wb") as f:
        pickle.dump({t: rng.randn(TINY_LEN, 64).astype(np.float32)
                     for t in takes}, f)
    n = TINY_LEN - 2 * TINY_M
    mimic = {t: _make_traj(i)[:n] for i, t in enumerate(takes)}
    mimic_res = {"traj_pred": mimic, "traj_orig": mimic,
                 "vel_pred": {t: np.zeros((n, 58)) for t in takes}}
    win = {t: np.stack([_make_traj(i + w)[:TINY_M + TINY_EP]
                        for w in range(2)]) for i, t in enumerate(takes)}
    for workload, res in (("egomimic", mimic_res),
                          ("egoforecast", {"traj_pred": win,
                                           "traj_orig": win})):
        for data in ("test", WILD):
            path = os.path.join(root, "results", workload, "tiny", "results",
                                f"iter_0000_{data}.p")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump((res, {"algo": workload}), f)
    return root


def _trace_ranges(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def _files(pattern):
    return sorted(glob.glob(pattern))


MIMIC_RES = os.path.join("results", "egomimic", "tiny", "results")
FORECAST_RES = os.path.join("results", "egoforecast", "tiny", "results")
TRAIN = ["--cfg", "tiny", "--synthetic", "--batch-lanes", "2",
         "--episode-len", "3", "--min-batch", "6", "--max-iter", "2"]
BASE = {
    "ego_mimic": TRAIN,
    "ego_forecast": TRAIN,
    "ego_mimic_eval": ["--cfg", "tiny", "--synthetic"],
    "ego_forecast_eval": ["--cfg", "tiny", "--synthetic", "--gt-init"],
    "eval_pose": ["--egomimic-cfg", "tiny"],
    "eval_forecast": ["--egoforecast-cfg", "tiny"],
    "ego_mimic_eval_wild": ["--cfg", "tiny", "--test-feat", WILD],
    "ego_forecast_eval_wild": ["--cfg", "tiny", "--test-feat", WILD,
                               "--egomimic-iter", "0"],
    "eval_pose_wild": ["--egomimic-cfg", "tiny", "--data", WILD],
    "eval_forecast_wild": ["--egoforecast-cfg", "tiny", "--data", WILD],
}


def _check_training_variant(module, extra, out):
    """A training CLI on a VARIANTS config: the native checkpoint written
    at the save interval and resumed by --iter, VGAIL's discrim_loss in
    the log, or the objective trained."""
    from egopose_tpu_torch.rl.agent_ego import NATIVE_FILE
    workload = "egomimic" if module == "ego_mimic" else "egoforecast"
    cfg = extra[1]
    log = open(os.path.join("results", workload, cfg, "log",
                            "log.txt")).read()
    assert log.count("T_update") == 2                # two iterations
    if cfg == "tiny_save":
        models = os.path.join("results", workload, cfg, "models")
        assert os.listdir(models) == ["iter_0002.orbax"]
        assert os.listdir(os.path.join(models, "iter_0002.orbax")) \
            == [NATIVE_FILE]
        # --iter 2 --max-iter 2: the resume alone
        back = importlib.import_module(f"egopose_tpu_torch.cli.{module}") \
            .main(BASE[module] + extra + ["--iter", "2", "--device", "cpu"])
        _assert_equal_state(out, back)
        assert int(back.train_state.opt_value.count) > 0
    elif cfg == "tiny_disc":
        assert type(out).__name__ == "AgentVGAIL"
        assert log.count("discrim_loss") == 2
    else:
        assert out.objective == cfg[len("tiny_"):]
        assert all(bool(p.isfinite().all()) for n in out.nets
                   for p in n.parameters())


def _check_artifact(module, extra, out):
    """What the option wrote (paths relative to the run's directory)."""
    arg = " ".join(extra)
    if extra[0] == "--cfg":
        _check_training_variant(module, extra, out)
    elif arg == "--profile-dir x":
        ranges = _trace_ranges(os.path.join("x", "trace.json"))
        setup = _trace_ranges(os.path.join("x", "setup_trace.json"))
        want = {"setup.build_kernels", "setup.world", "setup.checkpoint"}
        if module in ("ego_mimic", "ego_forecast"):
            assert {"iteration", "sample", "update"} <= ranges, ranges
        else:
            assert {"eval.step", "env.finish"} <= ranges, ranges
            want.add("setup.encode")
        # the set-up's spans in its own trace, and none of the loop's
        assert want <= setup and not setup & ranges, setup
    elif module == "ego_mimic" and arg == "--render":
        npz = np.load(os.path.join(MIMIC_RES, "render_iter_0000.npz"))
        assert npz["rewards"].shape == (3, 2) and npz["actions"].shape \
            == (3, 2, 52)
        assert not os.path.exists(os.path.join("results", "egomimic", "tiny",
                                               "log", "log.txt"))
    elif module == "ego_forecast" and arg == "--render":
        # mean-action training without a log file or scalars
        assert out is not None
        assert _files(os.path.join("results", "egoforecast", "tiny", "log",
                                   "*")) == []
        assert not os.path.exists(os.path.join("results", "egoforecast",
                                               "tiny", "tb"))
    elif arg == "--engine mujoco":
        with open(os.path.join(MIMIC_RES, "iter_0000_test_mj.p"), "rb") as f:
            saved, meta = pickle.load(f)
        assert meta["engine"] == "mujoco" and set(saved["traj_pred"]) \
            == {"take_0", "take_1"}
    elif module == "ego_mimic_eval":
        replay = np.load(os.path.join(MIMIC_RES, "iter_0000_test_replay.npz"))
        np.testing.assert_array_equal(replay["pred__take_0"],
                                      out[0]["traj_pred"]["take_0"])
    elif module in ("ego_forecast_eval", "ego_mimic_eval_wild",
                    "ego_forecast_eval_wild") and arg != "--vis-model x":
        res_dir = MIMIC_RES if module == "ego_mimic_eval_wild" \
            else FORECAST_RES
        data = "test_gt" if module == "ego_forecast_eval" else WILD
        replay = np.load(os.path.join(res_dir,
                                      f"iter_0000_{data}_replay.npz"))
        assert replay.files and np.isfinite(replay[replay.files[0]]).all()
        assert _files(os.path.join(res_dir, f"iter_0000_{data}.*")) == [
            os.path.join(res_dir, f"iter_0000_{data}.{ext}")
            for ext in ("npz", "p")]
    elif module in ("eval_pose", "eval_forecast") \
            or (module == "eval_forecast_wild" and arg == "--mode vis"):
        assert out.endswith(".npz") and os.path.exists(out)
        assert sorted(np.load(out).files) == ["traj_0", "traj_1"]
    elif arg == "--stats-vis":
        prefix = "wild_statsvis_egomimic_" if module == "eval_pose_wild" \
            else "wildfc_statsvis_"
        assert len(_files(os.path.join("out", prefix + "*"))) == TINY_TAKES
        assert out
    elif module == "eval_pose_wild" and arg == "--mode vis":
        assert sorted(out) == ["take_0", "take_1"]
        assert all(os.path.exists(p) for p in out.values())
    else:
        # --multi / --vis-model outside a vis mode: taken, and the run
        # writes what it writes without them
        assert out
        if module == "ego_forecast_eval_wild":
            assert os.path.exists(os.path.join(FORECAST_RES,
                                               f"iter_0000_{WILD}.p"))


# (module, extra argv) of every option ROADMAP §1 items 2-4 lifted
LIFTED = [
    ("ego_mimic", ["--profile-dir", "x"]),
    ("ego_mimic", ["--render"]),
    ("ego_mimic_eval", ["--engine", "mujoco"]),
    ("ego_mimic_eval", ["--profile-dir", "x"]),
    ("ego_mimic_eval", ["--render"]),
    ("ego_forecast", ["--profile-dir", "x"]),
    ("ego_forecast", ["--render"]),
    ("ego_forecast_eval", ["--mode", "vis"]),
    ("ego_forecast_eval", ["--render"]),
    ("eval_forecast", ["--mode", "vis"]),
    ("eval_pose", ["--mode", "vis"]),
    ("ego_mimic_eval_wild", ["--render"]),
    ("ego_forecast_eval_wild", ["--mode", "vis"]),
    ("ego_forecast_eval_wild", ["--render"]),
    ("ego_forecast_eval_wild", ["--vis-model", "x"]),
    ("eval_pose_wild", ["--mode", "vis"]),
    ("eval_pose_wild", ["--stats-vis"]),
    ("eval_pose_wild", ["--multi"]),
    ("eval_pose_wild", ["--vis-model", "x"]),
    ("eval_forecast_wild", ["--mode", "vis"]),
    ("eval_forecast_wild", ["--stats-vis"]),
    ("eval_forecast_wild", ["--multi"]),
    ("eval_forecast_wild", ["--vis-model", "x"]),
    ("ego_mimic", ["--cfg", "tiny_save", "--ckpt-format", "orbax"]),
    ("ego_mimic", ["--cfg", "tiny_disc"]),
    ("ego_mimic", ["--cfg", "tiny_trpo"]),
    ("ego_mimic", ["--cfg", "tiny_a2c"]),
    ("ego_forecast", ["--cfg", "tiny_save", "--ckpt-format", "orbax"]),
    ("ego_forecast", ["--cfg", "tiny_trpo"]),
    ("ego_forecast", ["--cfg", "tiny_a2c"]),
]


@pytest.mark.parametrize("module,extra", LIFTED)
def test_lifted_option_runs(tiny_world, tmp_path, monkeypatch, module,
                            extra):
    import shutil
    import torch
    if module.endswith("_wild") and "vis" in " ".join(extra):
        pytest.importorskip("cv2")    # the wild composites draw with cv2
    root = str(tmp_path / "run")
    shutil.copytree(tiny_world, root)
    monkeypatch.chdir(root)
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_TAKES", str(TINY_TAKES))
    # the profiler records every host op: profile 4 eval steps
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_LEN", str(
        2 * TINY_M + 4 if module == "ego_mimic_eval"
        and extra[0] == "--profile-dir" else TINY_LEN))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    argv = BASE[module] + extra
    if "--device" in flags(f"egopose_tpu_torch.cli.{module}"):
        argv += ["--device", "cpu"]
    try:
        out = importlib.import_module(
            f"egopose_tpu_torch.cli.{module}").main(argv)
    finally:
        torch.set_num_threads(n)
    _check_artifact(module, extra, out)


# (module, extra argv) of each option of the parallel runtime
PARALLEL = [
    ("ego_mimic", ["--cfg", "tiny_save", "--dp-devices", "2"]),
    ("ego_mimic", ["--cfg", "tiny_tcn", "--sp-devices", "2"]),
    ("ego_mimic_eval", ["--cfg", "tiny_tcn", "--sp-devices", "2"]),
    ("ego_forecast", ["--cfg", "tiny_save", "--dp-devices", "2"]),
    ("state_reg", ["--dp-devices", "2"]),
    ("ego_mimic", ["--render", "--dp-devices", "2"]),
    ("ego_forecast", ["--render", "--dp-devices", "2"]),
]
SR_TRAIN = ["--cfg", "tiny", "--mode", "train", "--synthetic", "--max-epoch",
            "1"]


def _check_parallel_render(module, main, base):
    """--render on 2 ranks: ego_mimic's lead rank writes the whole sample,
    its lanes gathered in the one-process order and equal to the one-
    process sample's (float32); ego_forecast trains with mean actions,
    without a log file or scalars."""
    if module == "ego_forecast":
        assert _files(os.path.join("results", "egoforecast", "tiny", "log",
                                   "*")) == []
        assert not os.path.exists(os.path.join("results", "egoforecast",
                                               "tiny", "tb"))
        return
    _check_artifact(module, ["--render"], None)
    path = os.path.join(MIMIC_RES, "render_iter_0000.npz")
    sharded = dict(np.load(path))
    main(base + ["--render", "--device", "cpu"])
    one = np.load(path)
    assert sorted(sharded) == sorted(one.files)
    for key in one.files:
        np.testing.assert_allclose(sharded[key], one[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("module,extra", PARALLEL)
def test_parallel_option_runs(tiny_world, tmp_path, monkeypatch, module,
                              extra):
    """Each option runs its CLI in 2 gloo ranks (spawned; the call returns
    None) and writes the artifact the one-process run writes."""
    import shutil
    root = str(tmp_path / "run")
    shutil.copytree(tiny_world, root)
    monkeypatch.chdir(root)
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_TAKES", str(TINY_TAKES))
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_LEN", str(TINY_LEN))
    monkeypatch.setenv("EGOPOSE_SYN_LEN", "48")    # statereg: 4 chunks
    main = importlib.import_module(f"egopose_tpu_torch.cli.{module}").main
    base = SR_TRAIN if module == "state_reg" else BASE[module]
    argv = base + extra + ["--device", "cpu"]
    assert main(argv) is None
    if "--render" in extra:
        _check_parallel_render(module, main, base)
        return
    cfg = extra[1] if extra[0] == "--cfg" else "tiny"
    if module == "ego_mimic_eval":
        path = os.path.join("results", "egomimic", cfg, "results",
                            "iter_0000_test.p")
        with open(path, "rb") as f:
            sharded, _ = pickle.load(f)
        one, _ = main(base + ["--cfg", cfg, "--device", "cpu"])
        for key in one:
            for take in one[key]:
                np.testing.assert_array_equal(sharded[key][take],
                                              one[key][take])
        return
    workload = {"ego_mimic": "egomimic", "ego_forecast": "egoforecast",
                "state_reg": "statereg"}[module]
    last = "iter_0001.p" if module == "state_reg" else "iter_0002.p"
    models = os.path.join("results", workload, cfg, "models")
    assert os.listdir(models) == [last]
    log = open(os.path.join("results", workload, cfg, "log",
                            "log.txt")).read()
    # the lead rank alone logs
    assert log.count("epoch    0" if module == "state_reg"
                     else "T_update") == (1 if module == "state_reg" else 2)
