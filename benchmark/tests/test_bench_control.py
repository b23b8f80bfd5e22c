"""The control of each cell comes out not correct: the reference in
float32 with TF32 on, put in the program's place, fails at least one of
the cell's limits, while the program passes them all.  TF32 exists only on
the card, so the test runs there and skips elsewhere:

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""
from __future__ import annotations

import json
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

SIZES = {
    "egomimic-eval-b4": (dict(frames=400), {}),
    "egomimic-train-l1024": (dict(lanes=256), dict(min_batch_size=5120,
                                                   env_episode_len=20)),
    "egoforecast-train-l1024": (dict(lanes=256), dict(min_batch_size=5120,
                                                      env_episode_len=20)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails(workload, tmp_path, monkeypatch):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32, the control's precision, "
                    "exists only there")
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    from benchmark import calibrate
    with open(os.path.join(BENCH_DIR, "limits", workload + ".json")) as f:
        limits = json.load(f)["numbers"]
    traffic, config = SIZES[workload]
    for seed, prog, ctl, _ in calibrate.readings(
            workload, [2147483801, 2147483802, 2147483803], 2.0, True,
            traffic_overrides=traffic, config_overrides=config):
        assert all(prog[k] <= v for k, v in limits.items()), prog
        assert any(not ctl[k] <= v for k, v in limits.items()), ctl
