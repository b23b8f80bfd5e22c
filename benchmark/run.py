"""The benchmark of egopose_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell, its configuration and its traffic are read by name from
BENCHMARK.json and from the files under benchmark/ (configs/<config>.json,
traffic/<traffic>.json, limits/<cell>.json); the traffic's ``kind`` names
its driver (drivers/<kind>.py) and each metric's reader is
metrics/<metric>.py.  With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.  The last
line of standard output is the result (JSON); the last lines of standard
error are the numbers compared against the reference, each beside its
limit.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "egopose_tpu")


def process_start() -> float:
    """This process's start on the time.time() clock (Linux /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


class Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def cell(name: str) -> tuple:
    """(BENCHMARK.json, the cell's entry, its config entry)."""
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return bench, wl, cfg


def load(wl: dict, cfg_entry: dict, traffic_overrides=None,
         config_overrides=None) -> tuple:
    """(configuration, traffic, driver module) of a cell, found by name;
    the overrides shrink them for tests."""
    from benchmark import common
    config = common.load_json(os.path.relpath(
        os.path.join(REPO_DIR, cfg_entry["file"]), BENCH_DIR))
    config["yaml"].update(config_overrides or {})
    traffic = dict(common.load_json("traffic", wl["traffic"] + ".json"),
                   **(traffic_overrides or {}))
    # tensorboard, which the program's scalar writer uses where it is
    # installed, imports TensorFlow where it can, and TensorFlow imports
    # JAX: the run keeps TensorFlow out (tensorboard then writes its event
    # files without it)
    if "tensorflow" not in sys.modules:
        sys.modules["tensorflow"] = None
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    return config, traffic, driver


def metrics_for(bench: dict, name: str, trace: bool) -> list:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def read_metrics(specs: list, run) -> dict:
    out = {}
    for m in specs:
        path = os.path.join(BENCH_DIR, "metrics", m["name"] + ".py")
        value = load_module(path, "metric_" + m["name"].replace(".", "_")) \
            .read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None, device=None, traffic_overrides=None,
         config_overrides=None) -> int:
    """Run one cell.  Tests only: ``device`` skips the look for a card and
    runs on the device given; ``traffic_overrides`` and
    ``config_overrides`` shrink the traffic and the configuration."""
    # the process's start on the perf_counter clock the drivers stamp with
    t0 = time.perf_counter() - (time.time() - process_start())
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, wl, cfg_entry = cell(args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(wl["chips"]):
            print(f"needs {wl['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)
    if REPO_DIR not in sys.path:
        sys.path.insert(0, REPO_DIR)
    try:
        import egopose_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 3

    config, traffic, driver = load(wl, cfg_entry, traffic_overrides,
                                   config_overrides)
    from benchmark import common
    limits = common.load_json("limits", wl["name"] + ".json")["numbers"]
    ctx = Ctx(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              workload=dict(traffic, name=wl["name"]), config=config,
              device=device, t0=t0)
    run, payload = driver.run(ctx)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        print(f"modules of {bad} were loaded in the measured process",
              file=sys.stderr)
        return 4

    numbers = driver.check(ctx, payload)
    checks, correct = {}, True
    for name, limit in limits.items():
        v = numbers[name]
        ok = not (isinstance(v, float) and math.isnan(v)) and v <= limit
        correct &= ok
        checks[name] = {"value": v, "limit": limit}
    metrics = read_metrics(metrics_for(bench, wl["name"], args.trace), run)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": dev}
    if args.trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"modules of {bad} were loaded in the measured process",
              file=sys.stderr)
        return 4
    if run.host:
        print("host " + json.dumps(run.host), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = REPO_DIR       # the package benchmark, not its files
    sys.exit(main())
