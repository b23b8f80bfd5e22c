"""The port's spans (egopose_tpu_torch/utils/profile.py) on the CPU:

- off, ``span`` returns the shared no-op: it reads the profiler's flag
  once, calls no torch function and never enters ``record_function``;
- on through ``enable()``, an eval of 2 takes x 3 steps and one training
  iteration (one segment) of each configuration give the span tree of
  PERF.md §3: names, parents, keys, children inside their parents, each
  span under a step's root once a control step, and the hooks outside the
  roots;
- under torch.profiler a span is a ``user_annotation`` event of its name,
  its start on the trace's clock within 1 ms of the event's; a span cut
  by the profiler's start or stop is dropped;
- tracing changes no output: the eval's results and the trained weights
  are bitwise equal with tracing on and off;
- ``SampleLog.sample_time`` and the ``t_update`` given to ``iter_hook``
  are the ``sample`` and ``update`` spans' seconds.

Outputs go to temporary directories."""
import json
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from egopose_tpu_torch.utils import profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_STEPS, TRAIN_STEPS = 3, 3
EVAL_SPANS = ("eval.record", "env.filter", "nets.policy", "nets.value",
              "env.step", "eval.failsafe")
ROLLOUT_SPANS = ("nets.policy", "env.step", "env.reanchor",
                 "env.filter_push", "env.filter_apply")
SETUP_SPANS = ("setup.build_kernels", "setup.world", "setup.checkpoint")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracer_off():
    profile.disable()
    profile.clear()
    yield
    profile.disable()
    profile.clear()


def _workdir(root):
    """``root`` with config/ and the committed ego-mimic models linked in
    (the forecast warm-starts from them)."""
    os.makedirs(os.path.join(root, "results", "egomimic", "subject_03"))
    os.symlink(os.path.join(REPO, "config"), os.path.join(root, "config"))
    os.symlink(os.path.join(REPO, "results", "egomimic", "subject_03",
                            "models"),
               os.path.join(root, "results", "egomimic", "subject_03",
                            "models"))
    return root


def _open_names():
    return [s.name for s in profile.TRACER._open]


def _run_eval(root, traced):
    """ego_mimic_eval on 2 synthetic takes x EVAL_STEPS steps: (results,
    the spans, what the hooks saw open)."""
    from egopose_tpu_torch.cli import ego_mimic_eval
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv("EGOPOSE_SYNTHETIC_TAKES", "2")
        mp.setenv("EGOPOSE_SYNTHETIC_LEN", str(20 + EVAL_STEPS))
        profile.clear()
        if traced:
            profile.enable()
        try:
            res, _ = ego_mimic_eval.main(
                ["--cfg", "subject_03", "--synthetic", "--iter", "3000",
                 "--device", "cpu"],
                step_hook=lambda t: seen.append(_open_names()),
                phys_hook=lambda *a: seen.append(_open_names()))
        finally:
            profile.disable()
    return res, profile.spans(), seen


def _run_train(root, kind, traced):
    """One training iteration (one TRAIN_STEPS-step segment of 2 lanes):
    (the agent's weights, the spans, the iter_hook's arguments, what it
    saw open)."""
    if kind == "mimic":
        from egopose_tpu_torch.cli import ego_mimic as cli
        cfg = "subject_03"
    else:
        from egopose_tpu_torch.cli import ego_forecast as cli
        cfg = "subject_03_syn"
    hooked = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv("EGOPOSE_SYNTHETIC_TAKES", "2")
        mp.setenv("EGOPOSE_SYNTHETIC_LEN", "60")
        profile.clear()
        if traced:
            profile.enable()
        try:
            agent = cli.main(
                ["--cfg", cfg, "--synthetic", "--device", "cpu",
                 "--batch-lanes", "2", "--episode-len", str(TRAIN_STEPS),
                 "--min-batch", str(2 * TRAIN_STEPS), "--max-iter", "1"],
                iter_hook=lambda i, log, metrics, t_update: hooked.append(
                    (i, log, t_update, _open_names())))
        finally:
            profile.disable()
    weights = [p.detach().clone() for net in agent.nets
               for p in net.parameters()]
    return weights, profile.spans(), hooked


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    on = _run_eval(_workdir(str(tmp_path_factory.mktemp("on"))), True)
    off = _run_eval(_workdir(str(tmp_path_factory.mktemp("off"))), False)
    return on, off


@pytest.fixture(scope="module", params=["mimic", "forecast"])
def train_runs(request, tmp_path_factory):
    kind = request.param
    on = _run_train(_workdir(str(tmp_path_factory.mktemp("on"))), kind,
                    True)
    off = _run_train(_workdir(str(tmp_path_factory.mktemp("off"))), kind,
                     False)
    return kind, on, off


def _tree(spans):
    by_id = {s.id: s for s in spans}
    kids = {s.id: [] for s in spans}
    for s in spans:
        if s.parent in kids:
            kids[s.parent].append(s)
    return by_id, kids


def _assert_nested(spans):
    by_id, _ = _tree(spans)
    for s in spans:
        assert s.start <= s.end, s
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start <= s.start and s.end <= up.end, (up, s)


def _names(spans):
    return Counter(s.name for s in spans)


# -- off ---------------------------------------------------------------------

def test_off_span_is_the_shared_noop(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered while off")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    s = profile.span("env.step")
    assert s is profile.OFF and profile.span("nets.policy", 3) is profile.OFF
    with s:
        pass
    with profile.timed("sample") as t:
        pass
    assert t.seconds >= 0
    assert profile.spans() == []


def test_off_path_reads_one_profiler_flag_and_calls_no_torch(monkeypatch):
    class Flags:
        reads = 0

        @property
        def _is_profiler_enabled(self):
            Flags.reads += 1
            return False

    monkeypatch.setattr(profile, "_autograd_profiler", Flags())
    calls = []

    def watch(frame, event, arg):
        if event == "c_call":
            calls.append(("c", getattr(arg, "__qualname__", repr(arg))))
        elif event == "call":
            calls.append(("py", frame.f_code.co_name,
                          frame.f_globals.get("__name__")))

    sys.setprofile(watch)
    try:
        with profile.span("env.finish"):
            pass
    finally:
        sys.setprofile(None)
    assert Flags.reads == 1
    assert [c for c in calls if c[0] == "c"] == [("c", "setprofile")]
    py = [c for c in calls if c[0] == "py"
          and c[1] != "_is_profiler_enabled"]      # the flag read above
    assert {c[2] for c in py} == {profile.__name__}
    assert {c[1] for c in py} == {"span", "__enter__", "__exit__"}


# -- on: the span tree ---------------------------------------------------------

def test_eval_span_tree(eval_runs):
    (_, spans, seen), _ = eval_runs
    _assert_nested(spans)
    by_id, kids = _tree(spans)
    names = _names(spans)
    for n in SETUP_SPANS + ("setup.encode", "eval.rollout"):
        assert names[n] == 1, (n, names)
        s = next(x for x in spans if x.name == n)
        assert s.parent is None and s.key is None
    roots = [s for s in spans if s.name == "eval.step"]
    assert [s.key for s in roots] == list(range(EVAL_STEPS))
    rollout = next(s for s in spans if s.name == "eval.rollout")
    for root in roots:
        assert root.parent == rollout.id
        assert Counter(k.name for k in kids[root.id]) == \
            Counter(EVAL_SPANS), kids[root.id]
        for k in kids[root.id]:
            assert k.key == root.key
        step = next(k for k in kids[root.id] if k.name == "env.step")
        assert sorted(k.name for k in kids[step.id]) == \
            ["env.finish", "physics.control_step"]
    for n in EVAL_SPANS + ("env.finish", "physics.control_step"):
        assert names[n] == EVAL_STEPS, (n, names)
    # the hooks run outside the step's root
    assert len(seen) == 2 * EVAL_STEPS
    assert all(s == ["eval.rollout"] for s in seen), seen


def test_train_span_tree(train_runs):
    kind, (_, spans, hooked), _ = train_runs
    _assert_nested(spans)
    by_id, kids = _tree(spans)
    names = _names(spans)
    for n in SETUP_SPANS:
        assert names[n] == 1, (n, names)
    it = next(s for s in spans if s.name == "iteration")
    assert it.key == 0 and it.parent is None
    assert sorted(k.name for k in kids[it.id]) == \
        ["sample", "sample.log", "update"]
    sample = next(s for s in spans if s.name == "sample")
    seg = next(s for s in spans if s.name == "rollout.segment")
    assert seg.parent == sample.id
    assert Counter(k.name for k in kids[seg.id]) == \
        Counter({"rollout.encode": 1, "rollout.step": TRAIN_STEPS})
    roots = [s for s in spans if s.name == "rollout.step"]
    assert [s.key for s in roots] == [(0, t) for t in range(TRAIN_STEPS)]
    per_step = ROLLOUT_SPANS + (("nets.context_step",)
                                if kind == "forecast" else ())
    for root in roots:
        assert Counter(k.name for k in kids[root.id]) == \
            Counter(per_step), kids[root.id]
        assert all(k.key == root.key for k in kids[root.id])
    for n in per_step + ("env.finish", "physics.control_step"):
        assert names[n] == TRAIN_STEPS, (n, names)
    update = next(s for s in spans if s.name == "update")
    epochs = [s for s in kids[update.id] if s.name == "update.epoch"]
    assert [s.name for s in kids[update.id]][0] == "update.advantages"
    assert len(epochs) == 10          # num_optim_epoch, full-batch PPO
    for e in epochs:
        assert [k.name for k in kids[e.id]] == ["update.value_step",
                                                "update.policy_step"]
    # the iter_hook runs outside the iteration's root
    assert [h[3] for h in hooked] == [[]]


def test_sample_and_update_seconds_are_the_spans(train_runs):
    _, (_, spans, hooked), _ = train_runs
    (i, log, t_update, _), = hooked
    sample = next(s for s in spans if s.name == "sample")
    update = next(s for s in spans if s.name == "update")
    assert log.sample_time == (sample.end - sample.start) * 1e-9
    assert t_update == (update.end - update.start) * 1e-9
    assert 0 < log.sample_time and 0 < t_update


# -- on and off: the same outputs ------------------------------------------------

def test_eval_outputs_equal_on_and_off(eval_runs):
    (res_on, spans_on, _), (res_off, spans_off, _) = eval_runs
    assert spans_on and not spans_off
    for key in ("traj_pred", "traj_orig", "vel_pred"):
        assert res_on[key].keys() == res_off[key].keys()
        for take in res_on[key]:
            np.testing.assert_array_equal(res_on[key][take],
                                          res_off[key][take])


def test_training_outputs_equal_on_and_off(train_runs):
    _, (w_on, spans_on, h_on), (w_off, spans_off, h_off) = train_runs
    assert spans_on and not spans_off
    assert len(w_on) == len(w_off)
    for a, b in zip(w_on, w_off):
        assert torch.equal(a, b)
    assert h_on[0][1].avg_c_reward == h_off[0][1].avg_c_reward


# -- under torch.profiler --------------------------------------------------------

def test_span_is_a_trace_event_on_the_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile as tprofile
    x = torch.arange(16.0)
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        with profile.span("nets.policy", 5):
            y = torch.tanh(x * 2.0 + 1.0).sum()
    assert float(y) > 0
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    ev = [e for e in trace["traceEvents"] if e.get("name") == "nets.policy"
          and e.get("cat") == "user_annotation"]
    assert len(ev) == 1
    (s,) = profile.spans()
    assert s.name == "nets.policy" and s.key == 5 and s.parent is None
    trace_us = ev[0]["ts"] + trace["baseTimeNanoseconds"] / 1e3
    assert abs(s.start / 1e3 - trace_us) < 1e3
    assert ev[0]["dur"] * 1e3 >= 0.5 * (s.end - s.start)


def test_span_cut_by_the_profiler_is_dropped():
    from torch.profiler import ProfilerActivity, profile as tprofile
    x = torch.ones(4)
    cut_by_stop = None
    with tprofile(activities=[ProfilerActivity.CPU]):
        with profile.span("env.step"):
            x = x + 1
        cut_by_stop = profile.span("env.finish")
        cut_by_stop.__enter__()
        x = x * 2
    cut_by_stop.__exit__(None, None, None)
    cut_by_start = profile.timed("update")
    cut_by_start.__enter__()
    with tprofile(activities=[ProfilerActivity.CPU]):
        with profile.span("update.epoch"):
            x = x - 1
        cut_by_start.__exit__(None, None, None)
    assert [(s.name, s.parent) for s in profile.spans()] == \
        [("env.step", None), ("update.epoch", None)]
    assert cut_by_start.seconds > 0 and float(x.sum()) == 12.0
    assert profile.TRACER._open == []
