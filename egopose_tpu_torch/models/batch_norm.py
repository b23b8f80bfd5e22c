"""BatchNorm with flax's semantics (the JAX package's
``nn.BatchNorm(momentum=0.9)``, epsilon 1e-5).

flax updates ``running = 0.9 running + 0.1 batch`` (torch's momentum 0.1)
but feeds the *biased* batch variance into the running variance, where
torch's BatchNorm feeds the unbiased one.  This module normalises with
``F.batch_norm`` and rescales the variance it returns by (n-1)/n before
folding it into the running statistics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Over (N, C, ...) inputs: statistics per channel over every other
    axis.  Parameters and buffers keep torch's names (weight, bias,
    running_mean, running_var)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # momentum 1 makes F.batch_norm write this batch's mean and its
        # unbiased variance into the two scratch buffers
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(
                mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var, alpha=(1 - self.momentum) * (n - 1) / n)
        return y
