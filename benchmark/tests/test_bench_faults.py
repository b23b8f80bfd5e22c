"""A run whose timed path is broken underneath the harness comes out not
correct: on the CPU, at a few lanes, without the look for a card, once for
each fault a cell can have (a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced; the cells
run on one chip, so no exchange between chips can be left out)."""
from __future__ import annotations

import json
import os
import sys
import tempfile

import pytest
import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

from benchmark import run  # noqa: E402

EVAL = dict(takes=4, frames=30, warmup_steps=2, profile_steps=1)
TRAIN = dict(lanes=4, takes=2, frames=120, profile_steps=1)
TRAIN_CFG = dict(min_batch_size=40, env_episode_len=10)


def unchanged_physics(monkeypatch):
    from egopose_tpu_torch.physics import engine
    monkeypatch.setattr(engine, "pd_control_step",
                        lambda m, qpos, qvel, *a, **k: (qpos, qvel))


def half_physics(monkeypatch):
    from egopose_tpu_torch.physics import engine
    orig = engine.pd_control_step

    def step(m, qpos, qvel, ctrl, *a, **k):
        h = qpos.shape[0] // 2
        q, v = orig(m, qpos[:h], qvel[:h], ctrl[:h], *a, **k)
        return torch.cat([q, qpos[h:]]), torch.cat([v, qvel[h:]])
    monkeypatch.setattr(engine, "pd_control_step", step)


def one_take_physics(monkeypatch):
    """The control step leaves the first take's state unchanged."""
    from egopose_tpu_torch.physics import engine
    orig = engine.pd_control_step

    def step(m, qpos, qvel, *a, **k):
        q, v = orig(m, qpos, qvel, *a, **k)
        return torch.cat([qpos[:1], q[1:]]), torch.cat([qvel[:1], v[1:]])
    monkeypatch.setattr(engine, "pd_control_step", step)


def altered_action(monkeypatch):
    from egopose_tpu_torch.rl import nets
    orig = nets.PolicyGaussian.forward
    monkeypatch.setattr(nets.PolicyGaussian, "forward",
                        lambda self, x: (lambda m, s: (m + 1e-2, s))(
                            *orig(self, x)))


def unchanged_update(monkeypatch):
    from egopose_tpu_torch.rl import ppo
    monkeypatch.setattr(ppo.Adam, "step", lambda self, grads, skip=None:
                        None)


def late_unchanged_update(monkeypatch):
    """The update leaves the weights unchanged from the third iteration
    on: in the measured window, after the warm-up."""
    from egopose_tpu_torch.rl import agent_ego, ppo
    orig_update, orig_step = agent_ego.AgentEgo.update_params, ppo.Adam.step
    calls = [0]

    def update(self, batch):
        calls[0] += 1
        return orig_update(self, batch)

    def step(self, grads, skip=None):
        if calls[0] <= 2:
            orig_step(self, grads, skip)
    monkeypatch.setattr(agent_ego.AgentEgo, "update_params", update)
    monkeypatch.setattr(ppo.Adam, "step", step)


def half_batch(monkeypatch):
    from egopose_tpu_torch.rl import agent_ego, ppo
    orig = ppo.ppo_update

    def update(ts, hyper, batch, windows, **k):
        h = batch.rewards.shape[1] // 2
        half = type(batch)(*[x[:, :h] if x.dim() > 1 else x[:h]
                             for x in batch])
        return orig(ts, hyper, half, windows[:h], **k)
    monkeypatch.setattr(ppo, "ppo_update", update)
    del agent_ego


def altered_reward(monkeypatch):
    from egopose_tpu_torch.envs import humanoid
    orig = humanoid.REWARD_FUNCS["quat_v3"]
    monkeypatch.setitem(humanoid.REWARD_FUNCS, "quat_v3",
                        lambda *a: (lambda r, c: (r + 1e-2, c))(*orig(*a)))


def result(capsys, monkeypatch, tmp_path, workload, traffic, config=None):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    torch.set_num_threads(2)
    rc = run.main(["--workload", workload, "--seed", "2147483901",
                   "--seconds", "0.2"], device="cpu",
                  traffic_overrides=traffic, config_overrides=config)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, unchanged_physics, half_physics,
                                   one_take_physics, altered_action,
                                   altered_reward])
def test_eval_fault(fault, capsys, monkeypatch, tmp_path):
    if fault is not None:
        fault(monkeypatch)
    line = result(capsys, monkeypatch, tmp_path, "egomimic-eval-b4", EVAL)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("fault", [None, unchanged_update, half_batch,
                                   altered_reward, unchanged_physics,
                                   late_unchanged_update])
def test_train_fault(fault, capsys, monkeypatch, tmp_path):
    if fault is not None:
        fault(monkeypatch)
    line = result(capsys, monkeypatch, tmp_path, "egomimic-train-l1024",
                  TRAIN, TRAIN_CFG)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("fault", [None, half_batch])
def test_forecast_fault(fault, capsys, monkeypatch, tmp_path):
    if fault is not None:
        fault(monkeypatch)
    line = result(capsys, monkeypatch, tmp_path, "egoforecast-train-l1024",
                  TRAIN, TRAIN_CFG)
    assert line["correct"] is (fault is None), line["checks"]
