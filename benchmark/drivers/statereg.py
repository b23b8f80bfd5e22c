"""Traffic kind ``statereg``: state-regression training through the
configuration's CLI, ``egopose_tpu_torch.cli.state_reg.main(["--cfg", ...,
"--mode", "train", "--synthetic"])``: its prefetch thread, its pinned
host-to-device copy, ``train_step`` and ``torch.optim.Adam``, on the
synthetic world of ``takes`` x ``frames`` frames of ``res`` x ``res``
2-channel flow (``EGOPOSE_SYN_RES`` / ``_TAKES`` / ``_LEN``).

The CLI's ``step_hook`` is called before and after each training step.
The first ``warmup_steps`` steps are set-up (cuDNN's first calls, the
allocator's growth); the window is the steps after them and closes at
the end of the first step that starts once the clock has passed
``--seconds``: the hook waits for the card there and raises
``common.WindowClosed``.  It waits nowhere else, so the host runs ahead
of the card as the CLI lets it.
``--trace 1`` profiles ``profile_steps`` steps of the warm-up, ending two
steps before the window.

The window's last step is what the reference judges
(reference/statereg_check.py): its device batch; the weights, BatchNorm
statistics and Adam state before it (copied on the card before that
step alone) and after it; its gradients (``.grad``, which the next step
would clear); its loss; and the CNN's features and the head's
predictions, read by forward hooks registered on the program's ``cnn``
and ``linear`` modules (PyTorch's hooks; no function of the program is
replaced).  The window's real
frames (each chunk's frames with its margins, not the copies of its last
frame that pad it to ``fr_num`` + 30) are counted from its steps' masks
once it has closed.
"""
from __future__ import annotations

import inspect
import json
import os
import time

import torch

from .. import common

SECTIONS = ("statereg.cnn_forward", "statereg.cnn_backward")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def section_kernels(path: str) -> dict:
    """Per span name of SECTIONS: (device seconds, count) of the kernels
    whose launch (the runtime call of the same correlation id, on any
    thread: the backward's launches come from autograd's device thread)
    lies inside one of the span's intervals in the Chrome trace at
    ``path``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = {n: [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e["name"] == n]
             for n in SECTIONS}
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    out = {n: [0.0, 0] for n in SECTIONS}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for n, ivs in spans.items():
            if any(a <= t <= b for a, b in ivs):
                out[n][0] += e["dur"] * 1e-6
                out[n][1] += 1
    return out


class SectionSlices(common.Slices):
    """common.Slices that also keep, per slice, the device time of the
    kernels launched inside the CNN's spans (``section_kernels``, read
    from the trace as the profiler exports it) and the program's frame
    counters over the slice."""

    def start(self, tag: str):
        from egopose_tpu_torch.utils import profile
        self._counts0 = counts(profile)
        super().start(tag)

    def stop(self, units: int):
        from egopose_tpu_torch.utils import profile
        export, sections = self._prof.export_chrome_trace, {}

        def export_and_read(path):
            export(path)
            sections.update(section_kernels(path))
        self._prof.export_chrome_trace = export_and_read
        super().stop(units)
        self.slices[-1].update(
            sections=sections,
            counts={k: v - self._counts0.get(k, 0)
                    for k, v in counts(profile).items()})

    def record(self) -> dict:
        out = super().record()
        sec = {n: [0.0, 0] for n in SECTIONS}
        cnt = {}
        for s in self.slices:
            for n, (t, k) in s["sections"].items():
                sec[n][0] += t
                sec[n][1] += k
            for k, v in s["counts"].items():
                cnt[k] = cnt.get(k, 0) + v
        return dict(out, sections=sec, counts=cnt)


def counts(profile) -> dict:
    """The program's counters (none in a program without them)."""
    read = getattr(profile, "counts", None)
    return read() if read is not None else {}


def write_config(wd: str, config: dict, seed: int) -> str:
    """<wd>/config/statereg/<cfg_id>.yml: the configuration's YAML with
    the seed set.  Returns the cfg id."""
    import yaml
    cfg_id = config["cfg_id"]
    os.makedirs(os.path.join(wd, "config", "statereg"))
    body = dict(config["yaml"], seed=common.program_seed(seed))
    with open(os.path.join(wd, "config", "statereg", cfg_id + ".yml"),
              "w") as f:
        yaml.safe_dump(body, f)
    return cfg_id


def device_state(net, opt) -> dict:
    """Weights, buffers and Adam's state, copied on the card."""
    params = dict(net.named_parameters())
    st = [opt.state.get(p, {}) for p in params.values()]
    return dict(
        params={k: p.detach().clone() for k, p in params.items()},
        buffers={k: b.detach().clone() for k, b in net.named_buffers()},
        adam=dict(step=int(st[0]["step"]) if st[0] else 0,
                  exp_avg={k: s["exp_avg"].clone()
                           for k, s in zip(params, st) if s},
                  exp_avg_sq={k: s["exp_avg_sq"].clone()
                              for k, s in zip(params, st) if s}))


def to_host(x):
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


def run(ctx) -> tuple:
    from egopose_tpu_torch.cli import state_reg
    if "step_hook" not in inspect.signature(state_reg.main).parameters:
        raise RuntimeError("this program's state_reg.main takes no "
                           "step_hook: the cell cannot be timed")
    wl, config = ctx.workload, ctx.config
    wd = common.workdir(wl["name"])
    cfg_id = write_config(wd, config, ctx.seed)
    warm, prof_n = int(wl["warmup_steps"]), int(wl["profile_steps"])
    prof_hi = warm - 2              # the profiled steps end here
    prof_lo = prof_hi - prof_n + 1
    device = ctx.device
    slices = SectionSlices(device, wd) if ctx.trace else None
    probe = common.HostProbe()
    seen = {}                        # the forward hooks' latest outputs
    keep = dict(window=[])   # the window's steps: (frames, mask, loss, end)
    marks = {}

    def watch(name):
        def hook(module, args, out):
            seen[name] = out.detach()
        return hook

    def step_hook(when, step, net, opt, batch, loss):
        now = time.perf_counter()
        if when == "before":
            if step == 0:
                net.cnn.register_forward_hook(watch("feats"))
                net.linear.register_forward_hook(watch("pred"))
            if step >= warm and now - marks["start"] >= ctx.seconds:
                keep.update(last=step, before=device_state(net, opt))
            return
        if step >= warm:
            keep["window"].append((batch[3], batch[2], loss, now))
        if slices is not None and step == prof_lo - 1:
            slices.start("step")
        elif slices is not None and step == prof_hi:
            slices.stop(prof_n)
        if step == warm - 1:
            common.sync(device)
            marks["start"] = time.perf_counter()
            probe.start()
        elif step == keep.get("last"):
            common.sync(device)
            marks["end"] = time.perf_counter()
            marks["host"] = probe.stop()
            keep.update(step=step, batch=batch, loss=loss,
                        after=device_state(net, opt),
                        grads={k: p.grad.detach().clone()
                               for k, p in net.named_parameters()},
                        feats=seen["feats"], pred=seen["pred"],
                        t=batch[0].shape[0])
            raise common.WindowClosed

    argv = ["--cfg", cfg_id, "--mode", "train", "--synthetic", "--device",
            str(device)]
    env = dict(EGOPOSE_SYN_RES=int(wl["res"]),
               EGOPOSE_SYN_TAKES=int(wl["takes"]),
               EGOPOSE_SYN_LEN=int(wl["frames"]))
    with common.chdir_env(wd, env):
        try:
            state_reg.main(argv, step_hook=step_hook)
        except common.WindowClosed:
            pass
    if "end" not in marks:
        raise RuntimeError("training ended before the window closed")
    win = keep["window"]
    run = common.Run(workload=wl, config=config, device=device)
    run.setup_s = marks["start"] - ctx.t0
    run.window_s = marks["end"] - marks["start"]
    stamps = [marks["start"]] + [w[3] for w in win[:-1]] + [marks["end"]]
    run.step_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    run.frames = int(sum(w[0] for w in win))
    margins = 2 * int(config["yaml"]["fr_margin"]) * int(sum(
        (w[1] > 0).any(0).sum() for w in win))
    losses = torch.stack([w[2] for w in win]).cpu()
    run.attempted = run.frames
    run.failed = int(sum(w[0] for w, l in zip(win, losses)
                         if not torch.isfinite(l)))
    run.host = dict(marks["host"], steps=len(win))
    if slices is not None:
        run.trace = slices.record()
    y = config["yaml"]
    t = keep["t"]
    run.work = dict(res=int(wl["res"]), in_ch=3, cnn_fdim=int(y["cnn_fdim"]),
                    v_hdim=int(y["v_hdim"]), mlp=list(y["mlp_dim"]),
                    state_dim=int(keep["pred"].shape[-1]),
                    real_frames=run.frames + margins)
    of, gt, mask, num = keep["batch"]
    payload = dict(step=keep["step"], res=int(wl["res"]),
                   takes=int(wl["takes"]), frames=int(wl["frames"]),
                   batch=to_host(dict(flow=of, gt=gt, mask=mask)),
                   before=to_host(keep["before"]),
                   after=to_host(keep["after"]), grads=to_host(keep["grads"]),
                   feats=to_host(keep["feats"]).reshape(
                       t, -1, keep["feats"].shape[-1]),
                   pred=to_host(keep["pred"]), loss=float(keep["loss"]))
    keep.clear()
    seen.clear()
    return run, payload


def check(ctx, payload, control=False) -> dict:
    """The comparison's numbers for what ``run`` recorded."""
    from ..reference import statereg_check
    return statereg_check.check(
        dict(ctx.config["yaml"], seed=common.program_seed(ctx.seed)),
        payload, ctx.device, control=control)
