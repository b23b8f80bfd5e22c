"""Running observation normalization (ZFilter), inference half
(counterpart of egopose_tpu/ops/running_norm.py).

``RunningStat`` keeps the JAX package's field names and NamedTuple shape, so
the committed checkpoints -- which pickle the JAX package's RunningStat --
unpickle into it (see convert.load_checkpoint_pickle)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class RunningStat(NamedTuple):
    n: object      # scalar count
    mean: object   # (D,)
    s: object      # (D,) sum of squared deviations


def to_tensors(stat: RunningStat, device) -> RunningStat:
    """The same statistics as tensors on ``device``, in the dtype they were
    stored in.  (The JAX package keeps a loaded checkpoint's float32
    statistics as they are, also in a float64 run, so its normalization
    computes the std in float32; so does the port.)"""
    as_t = lambda x: torch.as_tensor(x).to(device=device)
    return RunningStat(n=as_t(stat.n), mean=as_t(stat.mean), s=as_t(stat.s))


def std(stat: RunningStat) -> torch.Tensor:
    var = torch.where(stat.n > 1, stat.s / torch.clamp(stat.n - 1, min=1.0),
                      torch.square(stat.mean))
    return torch.sqrt(var)


def apply(stat: RunningStat, x: torch.Tensor, demean=True, destd=True,
          clip=5.0) -> torch.Tensor:
    """Normalize x with the stats (zfilter.py:56-67 semantics)."""
    if demean:
        x = x - stat.mean
    if destd:
        x = x / (std(stat) + 1e-8)
    if clip:
        x = torch.clamp(x, -clip, clip)
    return x
