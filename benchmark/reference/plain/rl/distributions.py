"""Diagonal Gaussian action distribution (counterpart of
egopose_tpu/rl/distributions.py) as plain tensor functions over
(mean, log_std)."""
from __future__ import annotations

import math

import torch


def diag_gaussian_log_prob(x, mean, log_std):
    """Sum-reduced log density over the last axis."""
    var = torch.exp(2.0 * log_std)
    ld = -((x - mean) ** 2) / (2 * var) - 0.5 * math.log(2 * math.pi) \
        - log_std
    return torch.sum(ld, -1)


def diag_gaussian_sample(mean, log_std, generator=None, noise=None):
    """mean + exp(log_std) * eps, eps standard normal: drawn from
    ``generator``, or the given ``noise`` (same shape as mean)."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(log_std) * noise
