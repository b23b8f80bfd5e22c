"""Readings that the correctness limits are set from (not part of a run).

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,3 \
        --seconds S [--control N]

Runs the cell's driver once per seed in one process (the kernels build
once) and prints, per seed, one JSON line with the program's numbers
and, for the first N seeds of ``--control N``, those of the control: the reference computed in
float32 with TF32 on and put in the program's place, judged the same
way.  The lower reading of a number is the largest the program gives
over a dozen seeds or more; the upper, the smallest the control gives.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)


def readings(workload: str, seeds, seconds: float, control: bool,
             device=None, traffic_overrides=None, config_overrides=None):
    """Yield (seed, program numbers, control numbers or None, metrics and,
    under ``host``, the window's host diagnostics)."""
    import torch
    from benchmark import run as runner
    bench, wl, cfg_entry = runner.cell(workload)
    config, traffic, driver = runner.load(wl, cfg_entry, traffic_overrides,
                                          config_overrides)
    device = torch.device(device or "cuda:0")
    for seed in seeds:
        ctx = runner.Ctx(seed=seed, seconds=seconds, trace=False,
                         workload=dict(traffic, name=wl["name"]),
                         config=config, device=device,
                         t0=time.perf_counter())
        run, payload = driver.run(ctx)
        metrics = runner.read_metrics(
            runner.metrics_for(bench, wl["name"], False), run)
        gc.collect()
        prog = driver.check(ctx, payload)
        ctl = driver.check(ctx, payload, control=True) if control else None
        del payload
        gc.collect()
        yield seed, prog, ctl, dict(metrics, host=run.host)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=0,
                    help="read the control on the first N seeds")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        seed, prog, ctl, metrics = next(readings(
            args.workload, [seed], args.seconds, i < args.control))
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              program=prog, control=ctl,
                              metrics={k: v["value"] if k != "host" else v
                                       for k, v in metrics.items()})),
              flush=True)


if __name__ == "__main__":
    sys.path[0] = REPO_DIR
    main()
