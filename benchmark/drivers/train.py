"""Traffic kind ``train``: PPO training through the configuration's CLI
(``egopose_tpu_torch.cli.ego_mimic.main`` or ``cli.ego_forecast.main``)
on the ``--synthetic`` world, ``lanes`` lanes, one segment an iteration.

An iteration is a sample and an update, back to back, read through the
CLI's ``iter_hook`` (the sample ends in a synchronisation, the update
reads its losses back).  The first ``warmup_iters`` iterations are
set-up: they build and warm every shape, and the reference follows them
(reference/train_check.py).  The window is the whole iterations after
them; it closes at the end of the iteration in which the clock passes
``--seconds``, and the reference follows that last iteration too, from
the weights and optimizer state the program had before it.  ``--trace 1`` profiles ``profile_steps`` control steps of
the last warm-up iteration's sample and one epoch of its update (from the
end of the first critic step to the end of the second).

Taps on ``envs.step``, ``running_norm.push_batch``,
``AgentEgo.update_params`` and ``Adam.step`` keep what the reference
judges: references to the program's tensors (every push of the filter;
the states, batch and losses of the warm-up and of the window's current
iteration), copied to the host once the window has closed, the weights
before and after the warm-up, and, on the device, the weights and
optimizer state before and after each window iteration's update.
"""
from __future__ import annotations

import time

import torch

from .. import common
from ..reference.eval_check import FIELDS


def run(ctx) -> tuple:
    wl, config = ctx.workload, ctx.config
    wd = common.workdir(wl["name"])
    cfg_id = common.write_program_config(wd, config, ctx.seed)
    lanes, warm = int(wl["lanes"]), int(wl["warmup_iters"])
    prof_n = int(wl["profile_steps"])
    kind = config["kind"]
    y = config["yaml"]
    if lanes * int(y["env_episode_len"]) < int(y["min_batch_size"]):
        raise ValueError("the driver records one segment an iteration: "
                         "lanes x env_episode_len must reach "
                         "min_batch_size")

    from egopose_tpu_torch import envs
    from egopose_tpu_torch.ops import running_norm
    from egopose_tpu_torch.rl import agent_ego, ppo
    if kind == "egoforecast":
        from egopose_tpu_torch.cli import ego_forecast as cli
    else:
        from egopose_tpu_torch.cli import ego_mimic as cli

    device = ctx.device
    state = dict(it=0, step=0, adam_calls=0)
    recs = {}           # iteration -> what the taps kept of it
    prog = dict(first_grads={})
    stamps, window, run_host = [], [], {}
    slices = common.Slices(device, wd) if ctx.trace else None
    probe = common.HostProbe()
    prof_it = warm - 1
    prof_lo = 10

    def rec():
        return recs.setdefault(state["it"], dict(steps=[], pushes=[]))

    def step_tap(orig):
        def step(model, p, tables, expert, st, action, end_reward=0.0,
                 *a, **k):
            if slices is not None and state["it"] == prof_it:
                if state["step"] == prof_lo:
                    slices.start("sample")
            new_st, out = orig(model, p, tables, expert, st, action,
                               end_reward, *a, **k)
            r = rec()
            r["steps"].append((st, new_st, out.reward, out.fail))
            r["end_reward"] = float(end_reward)
            state["step"] += 1
            if slices is not None and state["it"] == prof_it and \
                    state["step"] == prof_lo + prof_n:
                slices.stop(prof_n)
            return new_st, out
        return step

    def push_tap(orig):
        def push_batch(stat, x, *a, **k):
            rec()["pushes"].append(x)
            return orig(stat, x, *a, **k)
        return push_batch

    def update_tap(orig):
        def update_params(self, batch):
            r = rec()
            if state["it"] == 0:
                prog["params_before"] = snapshot(self)
                prog["opt_ids"] = (id(self.train_state.opt_policy),
                                   id(self.train_state.opt_value))
            r["batch"] = batch
            if state["it"] >= warm:
                r["before"] = device_state(self)
            state["adam_calls"] = 0
            out = orig(self, batch)
            r["losses"] = (out["policy_loss"], out["value_loss"])
            if state["it"] == warm - 1:
                prog["params_after"] = snapshot(self)
            if state["it"] >= warm:
                r["after"] = [p.detach().clone() for net in self.nets
                              for p in net.parameters()]
            return out
        return update_params

    def adam_tap(orig):
        def adam_step(self, grads, *a, **k):
            n = state["adam_calls"]
            orig(self, grads, *a, **k)
            if id(self) not in prog["first_grads"] and state["it"] < warm:
                prog["first_grads"][id(self)] = [
                    (m / (1 - self.B1)).detach().cpu() for m in self.mu]
            state["adam_calls"] = n + 1
            # one epoch: from the first critic step's end to the second's
            if slices is not None and state["it"] == prof_it:
                if n == 0:
                    slices.start("update")
                elif n == 2:
                    slices.stop(1)
        return adam_step

    def iter_hook(i_iter, log, metrics, t_update):
        common.sync(device)
        now = time.perf_counter()
        stamps.append(now)
        if i_iter >= warm:
            window.append(dict(steps=log.num_steps, sample_s=log.sample_time,
                               update_s=t_update,
                               segment_steps=int(round(log.num_steps
                                                       / lanes))))
        state["it"], state["step"] = i_iter + 1, 0
        if i_iter == warm - 1:
            probe.start()
        if i_iter >= warm and now - stamps[warm - 1] >= ctx.seconds:
            run_host.update(probe.stop())
            raise common.WindowClosed
        if i_iter >= warm:
            # only the window's last iteration is checked whole; the
            # filter's pushes of the others stay for the reference
            recs[i_iter] = dict(pushes=recs[i_iter]["pushes"])

    argv = ["--cfg", cfg_id, "--synthetic", "--batch-lanes", str(lanes),
            "--device", str(device)]
    env = dict(EGOPOSE_SYNTHETIC_TAKES=int(wl["takes"]),
               EGOPOSE_SYNTHETIC_LEN=int(wl["frames"]))
    with common.chdir_env(wd, env), \
            common.patched(envs, "step", step_tap), \
            common.patched(running_norm, "push_batch", push_tap), \
            common.patched(agent_ego.AgentEgo, "update_params",
                           update_tap), \
            common.patched(ppo.Adam, "step", adam_tap):
        try:
            cli.main(argv, iter_hook=iter_hook)
        except common.WindowClosed:
            pass
    if not window:
        raise RuntimeError("the training loop ended before the window")
    run = common.Run(workload=wl, config=config, device=device)
    run.setup_s = stamps[warm - 1] - ctx.t0
    run.window_s = stamps[-1] - stamps[warm - 1]
    run.iters = window
    run.host = dict(run_host, iter_s=[w["sample_s"] + w["update_s"]
                                      for w in window])
    run.attempted = int(sum(w["steps"] for w in window))
    if slices is not None:
        run.trace = slices.record()

    sample = sample_lanes(lanes, common.program_seed(ctx.seed))
    last = max(recs)
    iters = [host_iter(recs[i], sample) for i in range(warm)]
    iters += [dict(skip=True, pushes=host_pushes(recs[i]))
              for i in range(warm, last)]
    iters.append(dict(host_iter(recs[last], sample), window=True))
    before = recs[last]["before"]
    payload = dict(kind=kind, lanes=lanes, n_takes=int(wl["takes"]),
                   t_len=int(wl["frames"]), ckpt=config["checkpoint"],
                   iters=iters,
                   prog=dict(params_before=prog["params_before"],
                             params_after=prog["params_after"],
                             first_grads=[g for i in prog["opt_ids"]
                                          for g in prog["first_grads"][i]],
                             losses=[recs[i]["losses"]
                                     for i in list(range(warm)) + [last]],
                             window=dict(
                                 params_before=to_host(before["params"]),
                                 adam=[dict(mu=to_host(o["mu"]),
                                            nu=to_host(o["nu"]),
                                            count=int(o["count"]))
                                       for o in before["adam"]],
                                 params_after=to_host(recs[last]["after"])),
                             noise_device=str(device),
                             noise_dtype=torch.float32))
    recs.clear()
    after = [it["after_qpos"] for it in iters if not it.get("skip")]
    run.failed = 0      # a fall and its re-anchor are the rollout's work
    run.work = dict(kind=kind, lanes=lanes,
                    steps=int(sum(w["segment_steps"] for w in window)),
                    iters=len(window),
                    states=torch.cat([a[::8].reshape(-1, a.shape[-1])
                                      for a in after])[:256],
                    episode=int(config["yaml"]["env_episode_len"]),
                    epochs=int(config["yaml"]["num_optim_epoch"]))
    return run, payload


def device_state(agent) -> dict:
    """The agent's weights and both optimizers' moments and step counts,
    copied on the device (no synchronisation)."""
    ts = agent.train_state
    return dict(params=[p.detach().clone() for net in agent.nets
                        for p in net.parameters()],
                adam=[dict(mu=[m.clone() for m in o.mu],
                           nu=[v.clone() for v in o.nu],
                           count=o.count.clone())
                      for o in (ts.opt_policy, ts.opt_value)])


def to_host(xs) -> list:
    return [x.detach().cpu() for x in xs]


def host_pushes(r: dict) -> list:
    return [x.detach().cpu() for x in r["pushes"]]


def snapshot(agent) -> list:
    """The agent's weights, in the order policy, policy context, value,
    value context, copied to the host."""
    return [p.detach().cpu().clone() for net in agent.nets
            for p in net.parameters()]


def sample_lanes(lanes: int, seed: int):
    from ..reference.train_check import SAMPLE_LANES
    import numpy as np
    return torch.as_tensor(np.sort(np.random.RandomState(seed).choice(
        lanes, min(SAMPLE_LANES, lanes), replace=False)))


def host_iter(it: dict, lanes) -> dict:
    """One checked iteration's records on the host: the batch (all lanes),
    the states, actions' effects and flags at the sampled lanes, every
    push of the filter."""
    b = it["batch"]
    out = {k: getattr(b, k).detach().cpu()
           for k in ("states", "actions", "rewards", "masks", "exps",
                     "valids", "fails", "expert_ind", "start_ind")}
    dl = lanes.to(b.states.device)
    steps = it["steps"]
    for f in FIELDS:
        out["s_" + f] = torch.stack([getattr(s[0], f)[dl]
                                     for s in steps]).cpu()
    out["after_qpos"] = torch.stack([s[1].qpos[dl] for s in steps]).cpu()
    out["after_qvel"] = torch.stack([s[1].qvel[dl] for s in steps]).cpu()
    out["reward"] = torch.stack([s[2][dl] for s in steps]).cpu()
    out["fail"] = torch.stack([s[3][dl] for s in steps]).cpu()
    out["pushes"] = host_pushes(it)
    out["end_reward"] = it.get("end_reward", 0.0)
    return out


def check(ctx, payload, control=False) -> dict:
    import os
    from ..reference import train_check, world
    cfg = world.make_cfg(payload["kind"], dict(ctx.config["yaml"],
                                               seed=common.program_seed(ctx.seed)))
    ckpt = os.path.join(common.BENCH_DIR, payload["ckpt"])
    return train_check.check(payload["kind"], cfg, payload["n_takes"],
                             payload["t_len"], ckpt, payload["lanes"],
                             payload["iters"], payload["prog"], ctx.device,
                             control=control)
