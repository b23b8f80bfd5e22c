"""What the drivers share: the working directory a cell runs in, the taps
that record what the program's timed path produced, the profiled slice
and its reduction to device time, and the run record the metric readers
read."""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
from dataclasses import dataclass, field

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)


class WindowClosed(Exception):
    """Raised from a program hook once the measured window has closed: it
    ends the program's loop there."""


def load_json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def workdir(name: str) -> str:
    """A fresh working directory for the cell at a fixed path under TMPDIR
    (the program reads config/ and results/ relative to it and writes its
    logs there)."""
    import tempfile
    d = os.path.join(tempfile.gettempdir(), "egopose-benchmark", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def program_seed(seed: int) -> int:
    """The seed the configuration gets: --seed folded into the 32 bits that
    numpy's RandomState takes (the program seeds it with the config's
    seed), the same fold for the program and the reference."""
    return int(seed) % (1 << 32)


def write_program_config(wd: str, config: dict, seed: int) -> str:
    """The configuration as the program reads it:
    <wd>/config/<kind>/<cfg_id>.yml with the seed set, and the committed
    ego-mimic checkpoint (the eval's policy, the forecast's warm start) at
    <wd>/<checkpoint_at>.  Returns the cfg id."""
    import yaml
    kind, cfg_id = config["kind"], config["cfg_id"]
    os.makedirs(os.path.join(wd, "config", kind))
    body = dict(config["yaml"], seed=program_seed(seed))
    with open(os.path.join(wd, "config", kind, cfg_id + ".yml"), "w") as f:
        yaml.safe_dump(body, f)
    dst = os.path.join(wd, config["checkpoint_at"])
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy(os.path.join(BENCH_DIR, config["checkpoint"]), dst)
    return cfg_id


@contextlib.contextmanager
def chdir_env(path: str, env: dict):
    """The working directory and environment the program runs in.  The
    process stays in ``path`` afterwards: a training loop that the window
    ended leaves its summary writer's thread behind, which writes to
    paths relative to it."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    os.chdir(path)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def patched(obj, name: str, wrapper_factory):
    """Replace ``obj.name`` by ``wrapper_factory(original)`` for the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrapper_factory(orig))
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class HostProbe:
    """What the host did over the window, for the run's diagnostics on
    standard error: this process's CPU time (all its threads) over the
    wall time, and the time spent in Python's garbage collector."""

    def __init__(self):
        import gc
        self._gc, self._gc_t0, self.gc_s, self.gc_n = gc, None, 0.0, 0

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_n += 1

    def start(self):
        self._t, self._os = time.perf_counter(), os.times()
        self._gc.callbacks.append(self._on_gc)

    def stop(self) -> dict:
        self._gc.callbacks.remove(self._on_gc)
        wall = time.perf_counter() - self._t
        o, t = os.times(), self._os
        return dict(wall_s=wall,
                    process_cpu_share=(o.user + o.system - t.user - t.system)
                    / wall,
                    gc_s=self.gc_s, gc_collections=self.gc_n)


@dataclass
class Run:
    """What one run measured: the readers of benchmark/metrics/ take their
    numbers from here."""
    workload: dict
    config: dict
    device: object = None
    setup_s: float = 0.0
    window_s: float = 0.0
    step_s: list = field(default_factory=list)     # eval: every step
    frames: int = 0                                # eval: take-frames
    iters: list = field(default_factory=list)      # train: per iteration
    work: dict = field(default_factory=dict)       # counted operations
    trace: dict | None = None                      # --trace 1 only
    host: dict = field(default_factory=dict)       # diagnostics only
    attempted: int = 0
    failed: int = 0


# ---------------------------------------------------------------------------
# the profiled slice
# ---------------------------------------------------------------------------

class Slices:
    """Profiled slices of a run: ``start(tag)`` / ``stop(units)`` around
    host code, each slice synchronised at both ends and timed by the host
    clock, its Chrome trace reduced at once (``reduce_trace``) and
    deleted; ``record()`` sums the slices."""

    def __init__(self, device, out_dir: str):
        self.device, self.out_dir = device, out_dir
        self.slices, self._prof, self._t0, self._tag = [], None, None, None

    def start(self, tag: str):
        from torch.profiler import ProfilerActivity, profile
        sync(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._tag, self._t0 = tag, time.perf_counter()

    def stop(self, units: int):
        sync(self.device)
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        path = os.path.join(self.out_dir, f"trace_{len(self.slices)}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        self.slices.append(dict(tag=self._tag, wall_s=wall, units=units,
                                **reduce_trace(path)))
        os.remove(path)

    def record(self) -> dict:
        """Per tag: wall seconds, units (steps), kernels, device seconds
        by kernel name; over all: busy and window seconds, the top device
        operations and the idle gaps by host activity."""
        by_tag, ops, gaps = {}, {}, {}
        busy = window = 0.0
        for s in self.slices:
            t = by_tag.setdefault(s["tag"], dict(wall_s=0.0, units=0,
                                                 kernels=0, kernel_s={},
                                                 kernel_n={}))
            t["wall_s"] += s["wall_s"]
            t["units"] += s["units"]
            t["kernels"] += s["kernels"]
            for k, v in s["kernel_s"].items():
                t["kernel_s"][k] = t["kernel_s"].get(k, 0.0) + v
                t["kernel_n"][k] = t["kernel_n"].get(k, 0) + s["kernel_n"][k]
                ops[k] = ops.get(k, 0.0) + v
            for k, v in s["idle_s"].items():
                gaps[k] = gaps.get(k, 0.0) + v
            busy += s["busy_s"]
            window += s["wall_s"]
        top = lambda d: [[k[:120], v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return dict(tags=by_tag, busy_s=busy, window_s=window,
                    device_ops=top(ops), idle_gaps=top(gaps))


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_trace(path: str) -> dict:
    """One Chrome trace of torch.profiler: device kernels by name (count and
    seconds), the union of device-busy intervals, and the idle gaps
    between them attributed to the innermost host operation running at
    the gap's middle."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime",
                                                  "cuda_driver")]
    kernel_s, kernel_n = {}, {}
    for e in dev:
        if e["cat"] != "kernel":
            continue
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + e["dur"] * 1e-6
        kernel_n[e["name"]] = kernel_n.get(e["name"], 0) + 1
    busy, gaps, end = 0.0, [], None
    start = None
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if end is None or a > end:
            if end is not None:
                busy += (end - start)
                gaps.append((end, a))
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        busy += end - start
    idle = {}
    if gaps:
        hs = sorted(host, key=lambda e: e["ts"])
        starts = np.array([e["ts"] for e in hs])
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = int(np.searchsorted(starts, mid, side="right"))
            label, best = "host outside any operation", None
            for e in hs[max(0, i - 400):i]:
                if e["ts"] <= mid <= e["ts"] + e["dur"] and \
                        (best is None or e["dur"] < best):
                    label, best = e["name"], e["dur"]
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return dict(kernels=sum(kernel_n.values()), kernel_s=kernel_s,
                kernel_n=kernel_n, busy_s=busy * 1e-6, idle_s=idle)


def percentile(values, q: float) -> float:
    """The q-th percentile of all values (linear interpolation between the
    two nearest ranks, numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
