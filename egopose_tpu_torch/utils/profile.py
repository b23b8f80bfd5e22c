"""torch.profiler sessions of the CLIs' ``--profile-dir``: a Chrome trace
at ``<profile_dir>/trace.json`` (chrome://tracing or Perfetto open it)."""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def profiled(profile_dir, device, logger):
    """Record the body under torch.profiler -- the host and, on a CUDA
    ``device``, the card, waited for at the end -- and write it to
    ``<profile_dir>/trace.json``; with no ``profile_dir`` run the body as
    it is."""
    if not profile_dir:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("wrote profiler trace to %s" % path)
