"""Running observation normalization (ZFilter) (counterpart of
egopose_tpu/ops/running_norm.py): Welford statistics, the batched Chan
merge of a rollout batch, and the clipped z-normalization.

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


def init_stat(dim: int, dtype=torch.float32, device="cpu") -> RunningStat:
    return RunningStat(n=torch.zeros((), dtype=dtype, device=device),
                       mean=torch.zeros(dim, dtype=dtype, device=device),
                       s=torch.zeros(dim, dtype=dtype, device=device))


def push_batch(stat: RunningStat, x: torch.Tensor,
               weight: torch.Tensor | None = None, group=None) -> RunningStat:
    """Fold a batch (..., D) into the stats, optionally weighted per row:
    the Chan parallel-Welford merge, equal to pushing the rows one by one
    (zfilter.py:12-22).  An empty (zero-weight) batch changes nothing.

    ``group`` (parallel/mesh.Group): the batch is every rank's ``x``
    together.  The count and the weighted sum are summed over the ranks
    first, then the squared deviations about that global mean: two
    passes, so the merge equals the one-process merge to rounding."""
    if weight is None:
        weight = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    w = weight[..., None]
    dims = tuple(range(x.dim() - 1))
    nb = torch.sum(weight)
    sw = torch.sum(x * w, dims)
    if group is not None:
        both = group.sum(torch.cat([nb[None], sw]))
        nb, sw = both[0], both[1:]
    safe_nb = torch.clamp(nb, min=1.0)
    mb = sw / safe_nb
    sb = torch.sum(w * (x - mb) ** 2, dims)
    if group is not None:
        sb = group.sum(sb)
    n = stat.n + nb
    safe_n = torch.clamp(n, min=1.0)
    delta = mb - stat.mean
    mean = stat.mean + delta * nb / safe_n
    s = stat.s + sb + delta ** 2 * stat.n * nb / safe_n
    keep = nb > 0
    return RunningStat(n=torch.where(keep, n, stat.n),
                       mean=torch.where(keep, mean, stat.mean),
                       s=torch.where(keep, s, stat.s))


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
