"""The state-regression cell and the 4096-lane cell on the CPU, without the
look for a card:

- ``statereg-train-c4`` through ``run.main`` at a shrunken size (32x32
  flow, 2 takes x 250 frames: 6 chunks, two steps an epoch, the second
  padded) rebuilds the step's batch exactly and reads every other number
  within CPU_SLACK times its limit, with positive frames per second and
  the traced run's per-layer metrics that a CPU run has;
- with the program training on half of each batch, the same run reads
  numbers far beyond that;
- the parent of the step hooks (a ``state_reg.main`` without
  ``step_hook``) makes the cell fail at once, before any set-up;
- ``egomimic-train-l4096``'s traffic and limits files load: the l1024
  traffic at 4096 lanes, the numbers of the training cells.
"""
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

TINY = dict(res=32, takes=2, frames=250, warmup_steps=3, profile_steps=1)
# The limits are the card's (cuDNN's float32).  The CPU's float32
# convolutions and BatchNorm round coarser: at TINY the program reads
# feat_gap 1.4e-6 to 9e-6 and, in the worst tensor, grad_gap_cnn 2.6e-3
# to 3.4e-3, change_gap_cnn 1.8e-3 to 2.8e-3 on the CPU over 3 seeds,
# against the card's largest 6.6e-7, 3.9e-3 and 2.1e-3 over 29 to 42
# seeds at the timed size (limits/statereg-train-c4.json).
CPU_SLACK = 10


@pytest.fixture(autouse=True)
def _tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cell(capsys, trace=0):
    rc = run.main(["--workload", "statereg-train-c4", "--seed",
                   "4294967311", "--seconds", "0.5", "--trace", str(trace)],
                  device="cpu", traffic_overrides=TINY)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def within(checks: dict, slack: float) -> bool:
    return all(c["value"] <= c["limit"] * slack for c in checks.values())


def test_cell_reads_within_its_limits(capsys):
    out = cell(capsys, trace=1)
    assert out["checks"]["batch_mismatch"]["value"] == 0
    assert within(out["checks"], CPU_SLACK), out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    m = out["metrics"]
    assert m["temporal_ms_per_step.statereg"]["value"] > 0
    assert m["mfu.statereg"]["value"] > 0
    out = cell(capsys)
    assert within(out["checks"], CPU_SLACK), out["checks"]
    assert out["metrics"]["frames_per_s"]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0


def test_half_batch_is_not_correct(capsys, monkeypatch):
    from egopose_tpu_torch.cli import state_reg
    orig = state_reg.train_step

    def half(net, opt, of, gt, mask, *a, **k):
        h = of.shape[1] // 2
        return orig(net, opt, of[:, :h], gt[:, :h], mask[:, :h], *a, **k)
    monkeypatch.setattr(state_reg, "train_step", half)
    out = cell(capsys)
    assert not out["correct"]
    assert not within(out["checks"], 100 * CPU_SLACK), out["checks"]


def test_parent_without_step_hook_fails_at_once(monkeypatch):
    from egopose_tpu_torch.cli import state_reg
    monkeypatch.setattr(state_reg, "main",
                        lambda argv=None, epoch_hook=None: None)
    with pytest.raises(RuntimeError, match="step_hook"):
        run.main(["--workload", "statereg-train-c4", "--seed", "1",
                  "--seconds", "1"], device="cpu", traffic_overrides=TINY)
    assert not os.path.exists(os.path.join(tempfile.gettempdir(),
                                           "egopose-benchmark"))


def test_l4096_files_load():
    bench, wl, cfg = run.cell("egomimic-train-l4096")
    _, traffic, driver = run.load(wl, cfg)
    with open(os.path.join(BENCH_DIR, "traffic", "train-l1024.json")) as f:
        assert traffic == dict(json.load(f), lanes=4096)
    assert driver.__name__ == "benchmark.drivers.train"
    with open(os.path.join(BENCH_DIR, "limits",
                           "egomimic-train-l4096.json")) as f:
        limits = json.load(f)
    with open(os.path.join(BENCH_DIR, "limits",
                           "egomimic-train-l1024.json")) as f:
        assert set(limits["numbers"]) == set(json.load(f)["numbers"])
    assert set(limits["readings"]) == set(limits["numbers"])
