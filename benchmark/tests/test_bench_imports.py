"""No run of the benchmark loads JAX or the JAX package, and nothing under
benchmark/ reads the JAX package's benchmark files."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)

TINY = {"eval": dict(takes=2, frames=30, warmup_steps=2, profile_steps=1),
        "train": dict(lanes=2, takes=2, frames=120, profile_steps=1)}

SCRIPT = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from benchmark import run
rc = run.main(["--workload", {name!r}, "--seed", "7", "--seconds", "0.2"],
              device="cpu", traffic_overrides={traffic!r},
              config_overrides={config!r})
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(dict(rc=rc, top=top)))
"""


def cells():
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = []
    for w in bench["workloads"]:
        with open(os.path.join(BENCH_DIR, "traffic",
                               w["traffic"] + ".json")) as f:
            out.append((w["name"], json.load(f)["kind"]))
    return out


@pytest.mark.parametrize("name,kind", cells())
def test_no_jax_in_a_run(name, kind, tmp_path):
    config = {} if kind == "eval" else dict(min_batch_size=20,
                                            env_episode_len=10)
    code = SCRIPT.format(repo=REPO_DIR, name=name, traffic=TINY[kind],
                         config=config)
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["rc"] == 0, res.stderr[-3000:]
    loaded = set(line["top"])
    assert not loaded & {"jax", "jaxlib", "flax", "egopose_tpu"}
    assert "egopose_tpu_torch" in loaded


def test_no_file_reads_the_jax_benchmark():
    banned = [re.compile(p) for p in (
        r"(?<![\w.])bench\.py", r"(?<![\w/])tools[/]", r"BENCH_r\d",
        r"MULTICHIP_r\d", r"BASELINE\.(json|md)")]
    for root, _, files in os.walk(BENCH_DIR):
        for f in files:
            if not f.endswith((".py", ".json")):
                continue
            with open(os.path.join(root, f)) as fh:
                text = fh.read()
            for b in banned:
                assert not b.search(text), (f, b.pattern)
    for root, _, files in os.walk(os.path.join(BENCH_DIR, "reference")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    text = fh.read()
                assert not re.search(
                    r"^\s*(from|import)\s+(egopose_tpu|jax|jaxlib|flax)\b",
                    text, re.M), f


def test_bare_benchmark_folder_gives_no_result(tmp_path):
    shutil.copy(os.path.join(REPO_DIR, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "egomimic-eval-b4", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
