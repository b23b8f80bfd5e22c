"""The port's CLI surface against the JAX package's, on the CPU:

- every console script's twin takes the JAX CLI's flags, and adds none
  but ``--device``;
- eval_pose scores a state-regression results pickle (``--algo state_reg
  --statereg-cfg --statereg-iter``: results/statereg/<cfg>/results/
  iter_%04d_<data><tag>.p) and an ego-mimic one as the JAX CLI does, within
  1e-12, with the vis flags given;
- eval_pose and eval_forecast parse ``--multi``, ``--vis-model`` and
  ``--multi-vis-model``;
- every option the port refuses raises NotImplementedError naming its
  current ROADMAP §1 item.
"""
import argparse
import importlib
import os
import pickle
import re
import types

import numpy as np
import pytest
import yaml

from test_data_pipeline import _make_traj

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


# (module, extra argv, ROADMAP §1 item) of every option the port refuses
REFUSALS = [
    ("ego_mimic", ["--dp-devices", "2"], 5),
    ("ego_mimic", ["--sp-devices", "2"], 5),
    ("ego_mimic", ["--profile-dir", "x"], 2),
    ("ego_mimic", ["--render"], 2),
    ("ego_mimic", ["--ckpt-format", "orbax"], 3),
    ("ego_mimic", "discriminator", 4),
    ("ego_mimic_eval", ["--engine", "mujoco"], 2),
    ("ego_mimic_eval", ["--profile-dir", "x"], 2),
    ("ego_mimic_eval", ["--sp-devices", "2"], 5),
    ("ego_mimic_eval", ["--render"], 2),
    ("ego_forecast", ["--dp-devices", "2"], 5),
    ("ego_forecast", ["--profile-dir", "x"], 2),
    ("ego_forecast", ["--render"], 2),
    ("ego_forecast", ["--ckpt-format", "orbax"], 3),
    ("ego_forecast_eval", ["--mode", "vis"], 2),
    ("ego_forecast_eval", ["--render"], 2),
    ("eval_forecast", ["--mode", "vis"], 2),
    ("eval_pose", ["--mode", "vis"], 2),
    ("state_reg", ["--dp-devices", "2"], 5),
    ("ego_mimic_eval_wild", ["--render"], 2),
    ("ego_forecast_eval_wild", ["--mode", "vis"], 2),
    ("ego_forecast_eval_wild", ["--render"], 2),
    ("ego_forecast_eval_wild", ["--vis-model", "x"], 2),
    ("eval_pose_wild", ["--mode", "vis"], 2),
    ("eval_pose_wild", ["--stats-vis"], 2),
    ("eval_pose_wild", ["--multi"], 2),
    ("eval_pose_wild", ["--vis-model", "x"], 2),
    ("eval_forecast_wild", ["--mode", "vis"], 2),
    ("eval_forecast_wild", ["--stats-vis"], 2),
    ("eval_forecast_wild", ["--multi"], 2),
    ("eval_forecast_wild", ["--vis-model", "x"], 2),
    ("agent_ego", "policy_objective", 4),
]


@pytest.mark.parametrize("module,extra,item", REFUSALS)
def test_refusal_names_its_roadmap_item(tmp_path, monkeypatch, module, extra,
                                        item):
    monkeypatch.chdir(tmp_path)
    match = re.escape(f"ROADMAP §1 item {item}") + r"(?!\d)"
    if module == "agent_ego":
        from egopose_tpu_torch.rl.agent_ego import AgentEgo
        agent = types.SimpleNamespace(
            cfg=types.SimpleNamespace(policy_objective="trpo"))
        with pytest.raises(NotImplementedError, match=match):
            AgentEgo.update_params(agent, None)
        return
    main = importlib.import_module(f"egopose_tpu_torch.cli.{module}").main
    if extra == "discriminator":
        cfg = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                               "subject_03.yml")))
        cfg["discriminator"] = {"hdim": [32]}
        os.makedirs("config/egomimic")
        with open("config/egomimic/disc.yml", "w") as f:
            yaml.dump(cfg, f)
        argv = ["--cfg", "disc"]
    else:
        argv = ["--cfg", "x"] if module.startswith("ego") \
            or module == "state_reg" else []
        argv += extra
    with pytest.raises(NotImplementedError, match=match):
        main(argv + ["--device", "cpu"]
             if "--device" in flags(f"egopose_tpu_torch.cli.{module}")
             else argv)

