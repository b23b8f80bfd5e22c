"""The benchmark's reference (benchmark/reference/) against the program
on the CPU, in float64, at a few lanes: the world it works out again, the
nets, one control step of the env, the rollout's random numbers and one
PPO update.  The test imports the program; the reference does not."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
sys.path.insert(0, REPO_DIR)

from benchmark import common  # noqa: E402
from benchmark.reference import world as W  # noqa: E402
from benchmark.reference.plain import envs as RE  # noqa: E402

F64 = torch.float64
CKPT = os.path.join(BENCH_DIR, "data", "egomimic-subject03-iter3000.p")


def cfgs(name, seed=3):
    from egopose_tpu_torch.utils.config import (EgoForecastConfig,
                                                EgoMimicConfig)
    c = common.load_json("configs", name + ".json")
    y = dict(c["yaml"], seed=seed)
    cls = EgoForecastConfig if c["kind"] == "egoforecast" else EgoMimicConfig
    return c["kind"], W.make_cfg(c["kind"], y), cls("t", cfg_dict=y)


@pytest.fixture(scope="module")
def worlds():
    from egopose_tpu_torch.cli.ego_mimic import build_world
    kind, cfg_r, cfg_p = cfgs("egomimic-subject03")
    ref = W.build_world(cfg_r, 2, 60, F64, "cpu")
    prog = build_world(cfg_p, F64, torch.device("cpu"), synthetic=True,
                       synthetic_takes=2, synthetic_len=60)
    return cfg_r, cfg_p, ref, prog


def test_world(worlds):
    _, _, ref, (spec, model, tables, p, expert, cnn) = worlds
    for a, b in zip(ref.expert, expert):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ref.cnn_feat.numpy(), cnn, rtol=0, atol=0)
    assert ref.p.obs_dim == p.obs_dim and ref.p.nu == p.nu


def test_nets_and_env_step(worlds):
    from egopose_tpu_torch import envs
    from egopose_tpu_torch.rl.agent_ego import AgentEgo
    cfg_r, cfg_p, ref, (spec, model, tables, p, expert, cnn) = worlds
    agent = AgentEgo(model, spec, p, tables, expert, cnn, cfg_p,
                     batch_lanes=2, seed=3, dtype=F64, device="cpu")
    nets = W.make_nets("egomimic", cfg_r, p.obs_dim, p.nu, 3, F64, "cpu")
    for a, b in zip(agent.nets, (nets.policy, nets.policy_vs, nets.value,
                                 nets.value_vs)):
        for x, y in zip(a.parameters(), b.parameters()):
            assert torch.equal(x, y)
    agent.load(CKPT)
    zstat = W.load_mimic_checkpoint(nets, CKPT, F64, "cpu")
    x = torch.randn(3, p.obs_dim + 128, dtype=F64)
    torch.testing.assert_close(agent.policy_net(x)[0], nets.policy(x)[0],
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(agent.value_net(x), nets.value(x),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(agent.zstat.mean.double(), zstat.mean)
    gen = torch.Generator().manual_seed(0)
    st = envs.reset(model, p, tables, expert, gen, 2)
    rst = RE.EnvState(*st)
    action = 0.1 * torch.randn(2, p.nu, dtype=F64)
    for _ in range(3):
        new, out = envs.step(model, p, tables, expert, st, action)
        rnew, rout = RE.step(ref.model, ref.p, ref.tables, ref.expert, rst,
                             action)
        for a, b in zip(new, rnew):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
        for a, b in zip(out, rout):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
        st, rst = new, RE.EnvState(*new)


def test_noise_draw(worlds):
    from egopose_tpu_torch.rl import rollout
    _, _, ref, (spec, model, tables, p, expert, cnn) = worlds
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    for _ in range(2):
        a = rollout.draw_segment_noise(p, expert, 4, 1.0, g1)
        b = W.draw_noise(ref.p, ref.expert.lens, 2, 4, 1.0, g2, F64)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("name", ["egomimic-subject03",
                                  "egoforecast-subject03"])
def test_ppo_update(name):
    from egopose_tpu_torch.cli.ego_mimic import build_world
    from egopose_tpu_torch.rl.agent_ego import AgentEgo
    from egopose_tpu_torch.rl.agent_forecast import (AgentForecast,
                                                     warmstart_from_mimic)
    from egopose_tpu_torch.convert import load_checkpoint_pickle
    kind, cfg_r, cfg_p = cfgs(name)
    cfg_p.env_episode_len = cfg_r.env_episode_len = 6
    spec, model, tables, p, expert, cnn = build_world(
        cfg_p, F64, torch.device("cpu"), synthetic=True, synthetic_takes=2,
        synthetic_len=120)
    cls = AgentForecast if kind == "egoforecast" else AgentEgo
    agent = cls(model, spec, p, tables, expert, cnn, cfg_p, batch_lanes=3,
                seed=3, dtype=F64, device="cpu")
    ref = W.build_world(cfg_r, 2, 120, F64, "cpu")
    nets = W.make_nets(kind, cfg_r, p.obs_dim, p.nu, 3, F64, "cpu")
    if kind == "egoforecast":
        warmstart_from_mimic(agent, load_checkpoint_pickle(CKPT))
        W.warm_start(nets, CKPT)
    gen = torch.Generator().manual_seed(5)
    batch, _ = agent.sample(gen, 18)
    opts = W.make_adams(nets, cfg_r)
    data = {k: getattr(batch, k) for k in ("states", "actions", "rewards",
                                           "masks", "exps", "valids")}
    win = W.windows_of(kind, ref.cnn_feat, batch.expert_ind,
                       batch.start_ind, ref.p.fr_margin, 6)
    torch.testing.assert_close(win, agent._windows(batch))
    metrics = agent.update_params(batch)
    ploss, vloss = W.ppo_update(nets, opts, cfg_r, data, win)
    assert ploss == pytest.approx(metrics["policy_loss"], rel=1e-9)
    assert vloss == pytest.approx(metrics["value_loss"], rel=1e-9)
    for a, b in zip(agent.nets, nets):
        for x, y in zip(a.parameters(), b.parameters()):
            torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-12)
