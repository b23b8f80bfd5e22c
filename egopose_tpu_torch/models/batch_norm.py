"""BatchNorm with flax's semantics (the JAX package's
``nn.BatchNorm(momentum=0.9)``, epsilon 1e-5).

flax updates ``running = 0.9 running + 0.1 batch`` (torch's momentum 0.1)
but feeds the *biased* batch variance into the running variance, where
torch's BatchNorm feeds the unbiased one.  This module normalises with
``F.batch_norm`` and rescales the variance it returns by (n-1)/n before
folding it into the running statistics.

``group`` (parallel/mesh.Group), when set, makes the batch every rank's
``x`` together: count and sum are summed over the ranks, then the squared
deviations about that global mean, both through the differentiable
all-reduce, so the gradient sees the global moments as the one-process
batch does.  (torch.nn.SyncBatchNorm does not serve: it does not run on
the CPU ranks of gloo.)
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
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.group is not None:
            return self._global_batch(x)
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

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Training mode over every rank's batch (module docstring)."""
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        cnt_sum = self.group.sum_grad(torch.cat([
            x.new_full((1,), float(x.numel() // x.shape[1])), x.sum(dims)]))
        n, mean = cnt_sum[0], cnt_sum[1:] / cnt_sum[0]
        dev = x - mean.view(shape)
        var = self.group.sum_grad((dev * dev).sum(dims)) / n   # biased
        y = dev * torch.rsqrt(var + self.eps).view(shape) \
            * self.weight.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(
                mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var, alpha=1 - self.momentum)
        return y
