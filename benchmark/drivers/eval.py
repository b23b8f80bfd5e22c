"""Traffic kind ``eval``: the product inference path.

``egopose_tpu_torch.cli.ego_mimic_eval.main`` on the ``--synthetic``
world of the workload's takes (all takes as one batch), with the
configuration's checkpoint, the value fail-safe and mean actions.  Every
step ends in a synchronisation (a real-time consumer needs each frame's
pose before the next frame), stamped by the host clock through the CLI's
``step_hook``: ``warmup_steps`` steps of set-up, then the window, which
closes at the end of the step in which the clock passes ``--seconds``.
The loop ends there.  ``--trace 1`` profiles ``profile_steps`` steps of
the warm-up.

Every step's state, filtered observation, action, value, state after the
physics and reward are kept (references to the program's tensors, no
copies) by taps on ``envs.step``, ``running_norm.apply`` and
``Value.forward``, and judged after the window by the
reference (reference/eval_check.py).
"""
from __future__ import annotations

import time

from .. import common


def run(ctx) -> tuple:
    import torch
    wl, config = ctx.workload, ctx.config
    wd = common.workdir(wl["name"])
    cfg_id = common.write_program_config(wd, config, ctx.seed)
    margin = int(config["yaml"]["fr_margin"])
    n_takes, t_len = int(wl["takes"]), int(wl["frames"]) + 2 * margin
    warmup, prof_n = int(wl["warmup_steps"]), int(wl["profile_steps"])
    prof_lo = warmup - 10 - prof_n

    from egopose_tpu_torch import envs
    from egopose_tpu_torch.cli import ego_mimic_eval
    from egopose_tpu_torch.ops import running_norm
    from egopose_tpu_torch.rl import nets as program_nets

    device = ctx.device
    recs, last_value, last_zobs, stamps = [], [None], [None], []
    marks = {}
    slices = common.Slices(device, wd) if ctx.trace else None
    probe = common.HostProbe()

    def value_tap(orig):
        def forward(self, x):
            v = orig(self, x)
            last_value[0] = v
            return v
        return forward

    def zobs_tap(orig):
        def apply(*a, **k):
            last_zobs[0] = orig(*a, **k)
            return last_zobs[0]
        return apply

    def step_tap(orig):
        def step(model, p, tables, expert, state, action, *a, **k):
            new_st, out = orig(model, p, tables, expert, state, action,
                               *a, **k)
            recs.append((state, action, last_value[0], new_st, out.reward,
                         last_zobs[0]))
            return new_st, out
        return step

    def step_hook(t):
        common.sync(device)
        now = time.perf_counter()
        stamps.append(now)
        if slices is not None and t == prof_lo - 1:
            slices.start("step")
        elif slices is not None and t == prof_lo + prof_n - 1:
            slices.stop(prof_n)
        if t == warmup - 1:
            marks["start"] = now
            probe.start()
        elif t >= warmup and now - marks["start"] >= ctx.seconds:
            marks["end"], marks["last"] = now, t
            marks["host"] = probe.stop()
            raise common.WindowClosed

    argv = ["--cfg", cfg_id, "--synthetic", "--iter", str(wl["iter"]),
            "--device", str(device)]
    env = dict(EGOPOSE_SYNTHETIC_TAKES=n_takes, EGOPOSE_SYNTHETIC_LEN=t_len)
    with common.chdir_env(wd, env), \
            common.patched(envs, "step", step_tap), \
            common.patched(running_norm, "apply", zobs_tap), \
            common.patched(program_nets.Value, "forward", value_tap):
        try:
            ego_mimic_eval.main(argv, step_hook=step_hook)
        except common.WindowClosed:
            pass
    if "end" not in marks:
        raise RuntimeError(f"the takes ({wl['frames']} frames) ended before "
                           f"the window closed")
    run = common.Run(workload=wl, config=config, device=device)
    run.setup_s = marks["start"] - ctx.t0
    run.window_s = marks["end"] - marks["start"]
    lo, hi = warmup, marks["last"] + 1
    run.step_s = [stamps[t] - stamps[t - 1] for t in range(lo, hi)]
    run.frames = (hi - lo) * n_takes
    q = len(run.step_s) // 4
    run.host = dict(marks["host"], step_ms_by_quarter=[
        1e3 * sum(run.step_s[i * q:(i + 1) * q]) / max(q, 1)
        for i in range(4)])
    run.attempted = run.frames
    if slices is not None:
        run.trace = slices.record()

    # what the program produced, as CPU tensors (T, takes, ...)
    stack = lambda xs: torch.stack(xs).detach().cpu()
    states = [r[0] for r in recs]
    rec = {f: stack([getattr(s, f) for s in states])
           for f in ("qpos", "qvel", "cur_t", "expert_ind", "start_ind",
                     "prev_qpos", "prev_bquat", "bquat", "done")}
    rec["action"] = stack([r[1] for r in recs])
    rec["value"] = stack([r[2] for r in recs])
    rec["after_qpos"] = stack([r[3].qpos for r in recs])
    rec["after_qvel"] = stack([r[3].qvel for r in recs])
    rec["reward"] = stack([r[4] for r in recs])
    rec["zobs"] = stack([r[5] for r in recs])
    rec["next_qpos"], rec["next_qvel"] = rec["qpos"][1:], rec["qvel"][1:]
    win = rec["after_qpos"][lo:hi].reshape(-1, rec["after_qpos"].shape[-1])
    run.failed = int((~torch.isfinite(win).all(-1)).sum())
    run.work = dict(kind="eval", takes=n_takes, steps=hi - lo,
                    states=rec["qpos"][lo:hi:max(1, (hi - lo) // 16)]
                    .reshape(-1, rec["qpos"].shape[-1]))
    del recs, states
    ckpt = config["checkpoint"]
    return run, dict(kind="eval", rec=rec, n_takes=n_takes, t_len=t_len,
                     ckpt=ckpt)


def check(ctx, payload, control=False) -> dict:
    """The comparison's numbers for what ``run`` recorded."""
    import os
    from ..reference import eval_check, world
    cfg = world.make_cfg("egomimic", dict(ctx.config["yaml"],
                                          seed=common.program_seed(ctx.seed)))
    ckpt = os.path.join(common.BENCH_DIR, payload["ckpt"])
    return eval_check.check(cfg, payload["n_takes"], payload["t_len"], ckpt,
                            payload["rec"], ctx.device, control=control)
