"""The harness on the CPU: discovery by name, the contract's names and
units, the result line's keys, the percentile over all steps, and the
operation counts on fixed shapes."""
from __future__ import annotations

import json
import os
import re
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
sys.path.insert(0, REPO_DIR)

from benchmark import common, run, work  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_entry_has_its_files(bench):
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(REPO_DIR, c["file"]))
        cfg = common.load_json("configs", os.path.basename(c["file"]))
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert os.path.isfile(os.path.join(BENCH_DIR, cfg["checkpoint"]))
    for w in bench["workloads"]:
        traffic = common.load_json("traffic", w["traffic"] + ".json")
        assert os.path.isfile(os.path.join(BENCH_DIR, "drivers",
                                           traffic["kind"] + ".py"))
        assert common.load_json("limits", w["name"] + ".json")["numbers"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for path in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path)


def test_every_cell_reports_what_the_contract_asks(bench):
    for w in bench["workloads"]:
        e2e = run.metrics_for(bench, w["name"], False)
        per = run.metrics_for(bench, w["name"], True)
        assert any(m["name"] == "setup_s" for m in e2e)
        assert len(e2e) >= 2 and per


def test_percentile_over_all_steps():
    steps = [0.01] * 95 + [0.05] * 5
    assert common.percentile(steps, 95) == pytest.approx(0.01 + 0.04 * 0.05)
    assert common.percentile(list(range(101)), 95) == pytest.approx(95.0)


def test_k1_count_on_fixed_shapes():
    c = work.model_counts()
    assert (c["nd"], c["nq"], c["nu"]) == (58, 59, 52)
    nbytes, ops = work.k1_work(1024, 4, 4.0, 1.0)
    assert nbytes == 1024 * (59 + 58 + 4 * 52) * 4 + 1024 * (59 + 58) * 4 \
        + c["table_bytes"]
    rows = 3 * 4.0 + 1.0
    groups = 5
    prep = work.k1_prep_ops(c, rows) + 2 * (2 * c["nnz"] * 10) \
        + 2 * rows * c["nnz"] + rows * rows * 58
    sub = 20 * 58 + 12 * c["nnz"] + 4 * rows * 58 + 20 * rows * rows \
        + 20 * 58
    assert ops == 1024 * (groups * prep + 15 * sub)
    assert work.k1_bound_s(1024, 4.0, 1.0) == max(
        nbytes / work.PEAK_BYTES_PER_S, ops / work.PEAK_F32_FLOPS)


def test_mfu_count_on_fixed_shapes():
    cfg = common.load_json("configs", "egomimic-subject03.json")
    d = work.net_dims(cfg)
    assert d["n_in"] == 57 + 58 + 128 and d["hidden"] == [300, 200]
    mlp = 2 * (243 * 300 + 300 * 200 + 200 * 52) \
        + 2 * (243 * 300 + 300 * 200 + 200 * 1)
    k1 = work.k1_work(4, 4, 4.0, 1.0)[1]
    assert work.eval_step_flops(cfg, 4, 4.0, 1.0) == 4 * mlp + k1
    it = work.train_iter_flops(cfg, 1024, 50, 10, 4.0, 1.0)
    assert it > 50 * work.k1_work(1024, 4, 4.0, 1.0)[1]
    assert work.mlp_flops([3, 4, 5]) == 2 * (12 + 20)
    assert work.lstm_step_flops(64, 64) == 2 * 4 * 64 * 128 + 12 * 64


def tiny_eval(tmp_path, monkeypatch, trace=0, **faults):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return run.main(["--workload", "egomimic-eval-b4", "--seed",
                     "2147483999", "--seconds", "0.5", "--trace",
                     str(trace)], device="cpu",
                    traffic_overrides=dict(takes=2, frames=40,
                                           warmup_steps=14,
                                           profile_steps=1))


def test_result_line(tmp_path, monkeypatch, capsys):
    assert tiny_eval(tmp_path, monkeypatch, trace=1) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert err.strip().splitlines()[-1].startswith("check ")
    assert "mfu.eval" in line["metrics"]


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "egomimic-eval-b4", "--seed", "1",
                   "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""
