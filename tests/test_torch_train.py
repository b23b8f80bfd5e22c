"""The port's training CLI (python -m egopose_tpu_torch.cli.ego_mimic) on
the CPU at a tiny size: 2 synthetic takes x 40 frames, 4 lanes, 5-step
episodes, 2 iterations in float32.  It logs finite losses and rewards,
writes iter_0002.p in the JAX package's pickle layout, and the JAX
package's AgentEgo.load reads it back with nets and observation statistics
equal to the port's (exactly: the same float32 values).  A checkpoint the
JAX package wrote (the committed iter_0800.p) resumes in the port.  The
flags that are not ported raise, and without CUDA the default device
raises.  Outputs go to a temporary directory."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "results", "egomimic", "subject_03", "models")
ARGS = ["--cfg", "subject_03", "--synthetic", "--batch-lanes", "4",
        "--episode-len", "5", "--min-batch", "20"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """cwd with a copy of subject_03.yml saving every 2 iterations and the
    committed iter_0800.p; the synthetic world cut to 2 takes x 40."""
    cfg = yaml.safe_load(open(os.path.join(REPO, "config", "egomimic",
                                           "subject_03.yml")))
    cfg["save_model_interval"] = 2
    os.makedirs(tmp_path / "config" / "egomimic")
    with open(tmp_path / "config" / "egomimic" / "subject_03.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    models = tmp_path / "results" / "egomimic" / "subject_03" / "models"
    os.makedirs(models)
    os.symlink(os.path.join(MODELS, "iter_0800.p"), models / "iter_0800.p")
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_TAKES", "2")
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_LEN", "40")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_cli_trains_and_jax_loads_its_checkpoint(workdir):
    from egopose_tpu.physics.spec import parse_mjcf
    from egopose_tpu.rl import AgentEgo as JAgentEgo
    from egopose_tpu.utils import config as jcfg
    from egopose_tpu_torch.cli import ego_mimic
    from egopose_tpu_torch.convert import params_to_jax

    logs = []
    agent = ego_mimic.main(ARGS + ["--max-iter", "2", "--device", "cpu"],
                           iter_hook=lambda *a: logs.append(a))
    assert [i for i, *_ in logs] == [0, 1]
    for _, log, metrics, _ in logs:
        assert log.num_steps == 20
        assert np.isfinite([log.avg_c_reward, log.min_c_reward,
                            log.max_c_reward, metrics["policy_loss"],
                            metrics["value_loss"]]).all()
        assert 0 < log.min_c_reward and 0 < log.avg_c_reward
        assert ((log.avg_c_info > 0) & (log.avg_c_info <= 1)).all()
        assert metrics["policy_grad_skips"] == metrics["value_grad_skips"] \
            == 0
    # the first iteration has no end-of-episode bonus yet
    assert logs[0][1].max_c_reward <= 1
    path = "results/egomimic/subject_03/models/iter_0002.p"
    log_txt = open("results/egomimic/subject_03/log/log.txt").read()
    assert "saved checkpoint " + path in log_txt and "T_sample" in log_txt

    jc = jcfg.EgoMimicConfig("subject_03")
    jc.env_episode_len = 5
    spec = parse_mjcf(os.path.join(REPO, "assets", "mujoco_models",
                                   "humanoid_1205_v1.xml"))
    jp = jcfg.make_env_params(jc, spec, obs_dim=115, dtype=np.float32)
    jagent = JAgentEgo(None, spec, jp, None, None, np.zeros((2, 40, 64)), jc,
                       batch_lanes=4, seed=jc.seed, dtype=jnp.float32)
    jagent.load(path)
    want = params_to_jax(*[n.state_dict() for n in agent.nets])
    ts = jagent.train_state
    for got, exp in zip((ts.policy, ts.policy_vs, ts.value, ts.value_vs),
                        want):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(exp)
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, exp)
    for name in ("n", "mean", "s"):
        np.testing.assert_array_equal(np.asarray(getattr(jagent.zstat, name)),
                                      getattr(agent.zstat, name).numpy())


def test_cli_resumes_a_jax_checkpoint(workdir):
    from egopose_tpu_torch.cli import ego_mimic
    from egopose_tpu_torch.convert import load_checkpoint_pickle
    cp = load_checkpoint_pickle(os.path.join(MODELS, "iter_0800.p"))
    agent = ego_mimic.main(ARGS + ["--iter", "800", "--max-iter", "801",
                                   "--device", "cpu"])
    # the checkpoint's float32 statistics, with one segment pushed on top
    # in float32: the 4 reset observations, then 4 per step for 5 steps
    n = np.float32(cp["running_state"].n)
    for _ in range(6):
        n = np.float32(n + np.float32(4))
    assert agent.zstat.n.dtype == torch.float32 and float(agent.zstat.n) == n
    assert float(agent.zstat.n) > 1e8
    assert not os.path.exists(
        "results/egomimic/subject_03/models/iter_0801.p")


@pytest.mark.parametrize("extra", [["--dp-devices", "3"],
                                   ["--sp-devices", "2"]])
def test_cli_refuses_unported_options(workdir, extra):
    """The mesh flags the config cannot take are refused, with the JAX
    agent's messages, before any rank starts: 4 lanes over 3 ranks, and
    sequence parallelism over LSTM context nets."""
    from egopose_tpu_torch.cli import ego_mimic
    match = "not divisible" if extra[0] == "--dp-devices" \
        else "requires TCN context nets"
    with pytest.raises(ValueError, match=match):
        ego_mimic.main(ARGS + extra + ["--device", "cpu"])


def test_cli_without_cuda_raises(workdir, monkeypatch):
    from egopose_tpu_torch.cli import ego_mimic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ego_mimic.main(ARGS)
