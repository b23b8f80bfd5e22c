"""The per-layer host times read from the program's spans
(metrics/_spans.py and the ``*_ms_per_step.*`` readers): self times and
layer sums on made-up span records, spans whose slice cut their parent,
a program without the tracer (None), and a tiny ``--trace 1`` run of
egomimic-eval-b4 on the CPU that reports the four eval metrics, whose
layers, ``eval.record`` and the steps' own time add up to the step."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from typing import Any, NamedTuple

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
sys.path.insert(0, REPO_DIR)

from benchmark import run  # noqa: E402
from benchmark.metrics import _spans  # noqa: E402

EVAL_METRICS = ("env_ms_per_step.eval", "nets_ms_per_step.eval",
                "physics_ms_per_step.eval", "failsafe_ms_per_step.eval")


class Rec(NamedTuple):
    id: int
    name: str
    start: int
    end: int
    parent: Any
    key: Any


MS = 1_000_000      # ns


def eval_step(first_id, t, t0):
    """One eval step's spans (ns from t0): 10 ms in all, of which env 4
    (filter 1, step 0.5 own, finish 2.5), physics 1, nets 2, fail-safe
    1.5, record 0.5, the root's own 1."""
    i = first_id
    return [Rec(i, "eval.step", t0, t0 + 10 * MS, None, t),
            Rec(i + 1, "eval.record", t0, t0 + MS // 2, i, t),
            Rec(i + 2, "env.filter", t0 + MS, t0 + 2 * MS, i, t),
            Rec(i + 3, "nets.policy", t0 + 2 * MS, t0 + 3 * MS, i, t),
            Rec(i + 4, "nets.value", t0 + 3 * MS, t0 + 4 * MS, i, t),
            Rec(i + 5, "env.step", t0 + 4 * MS, t0 + 8 * MS, i, t),
            Rec(i + 6, "physics.control_step", t0 + 4 * MS + MS // 2,
                t0 + 5 * MS + MS // 2, i + 5, t),
            Rec(i + 7, "env.finish", t0 + 5 * MS + MS // 2, t0 + 8 * MS,
                i + 5, t),
            Rec(i + 8, "eval.failsafe", t0 + 8 * MS, t0 + 9 * MS + MS // 2,
                i, t)]


def test_layers_of_eval_steps():
    spans = eval_step(1, 0, 0) + eval_step(20, 1, 50 * MS)
    own = _spans.self_ns(spans)
    assert own[1] == MS and own[6] == MS // 2
    assert _spans.layer_ms(spans, "env") == pytest.approx(4.0)
    assert _spans.layer_ms(spans, "physics") == pytest.approx(1.0)
    assert _spans.layer_ms(spans, "nets") == pytest.approx(2.0)
    assert _spans.layer_ms(spans, "failsafe") == pytest.approx(1.5)
    means = _spans.mean_self_ms(spans)
    assert sum(means.values()) == pytest.approx(10.0)
    assert means["eval.step"] == pytest.approx(1.0)


def test_cut_slices_and_mean_a_call():
    """A slice that opens inside one step's physics and closes after the
    next step's: the first step's root and the env.step cut by the start
    are dropped (their children stay, without a kept parent), the last
    step's root is cut by the stop; each name's mean a call is its time a
    step."""
    step = eval_step(1, 0, 0)
    kept = [s for s in step if s.name in ("physics.control_step",
                                          "env.finish", "eval.failsafe")]
    nxt = eval_step(20, 1, 50 * MS)
    last = [s for s in eval_step(40, 2, 100 * MS)
            if s.name in ("eval.record", "env.filter", "nets.policy",
                          "nets.value")]
    spans = kept + nxt + last
    assert _spans.layer_ms(spans, "physics") == pytest.approx(1.0)
    assert _spans.layer_ms(spans, "env") == pytest.approx(4.0)
    assert _spans.layer_ms(spans, "nets") == pytest.approx(2.0)
    assert _spans.layer_ms(spans, "failsafe") == pytest.approx(1.5)


def test_no_spans_no_tracer(monkeypatch):
    assert _spans.layer_ms([], "env") is None
    assert _spans.layer_ms(eval_step(1, 0, 0), "failsafe") == \
        pytest.approx(1.5)
    only_env = [s for s in eval_step(1, 0, 0) if s.name.startswith("env")]
    assert _spans.layer_ms(only_env, "nets") is None
    # a program whose profile module has no tracer (the parent commit)
    bare = types.ModuleType("egopose_tpu_torch.utils.profile")
    import egopose_tpu_torch.utils as utils
    monkeypatch.setitem(sys.modules, "egopose_tpu_torch.utils.profile", bare)
    monkeypatch.setattr(utils, "profile", bare, raising=False)
    assert _spans.program_spans() is None
    for name in EVAL_METRICS + ("env_ms_per_step.train",
                                "nets_ms_per_step.train",
                                "physics_ms_per_step.train"):
        path = os.path.join(BENCH_DIR, "metrics", name + ".py")
        reader = run.load_module(path, "metric_" + name.replace(".", "_"))
        assert reader.read(None) is None, name


SCRIPT = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from benchmark import run
from benchmark.metrics import _spans
rc = run.main(["--workload", "egomimic-eval-b4", "--seed", "3000000019",
               "--seconds", "0.2", "--trace", "1"], device="cpu",
              traffic_overrides={traffic!r})
spans = _spans.program_spans()
steps = [s for s in spans if s.name == "eval.step"]
means = _spans.mean_self_ms(spans)
step_ms = sum(s.end - s.start for s in steps) / len(steps) * 1e-6
print(json.dumps(dict(rc=rc, step_ms=step_ms, means=means,
                      roots=len(steps))))
"""


def test_traced_eval_reports_the_layers(tmp_path):
    # test_bench_imports.py's tiny eval, its warm-up long enough to hold
    # the profiled step (10 steps before the window)
    traffic = dict(takes=2, frames=30, warmup_steps=12, profile_steps=1)
    code = SCRIPT.format(repo=REPO_DIR, traffic=traffic)
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    out = json.loads(next(l for l in lines if l.startswith('{"correct"')))
    info = json.loads(lines[-1])
    assert info["rc"] == 0 and out["correct"], res.stderr[-3000:]
    for name in EVAL_METRICS:
        assert out["metrics"][name]["value"] > 0, name
        assert out["metrics"][name]["unit"] == "ms"
    # one profiled step: its layers, its record and its own time are it
    assert info["roots"] == 1
    parts = sum(out["metrics"][n]["value"] for n in EVAL_METRICS) + \
        info["means"]["eval.record"] + info["means"]["eval.step"]
    assert parts == pytest.approx(info["step_ms"], rel=1e-9)
