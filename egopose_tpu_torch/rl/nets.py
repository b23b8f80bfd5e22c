"""Policy and value networks (counterpart of egopose_tpu/rl/nets.py)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..models.mlp import MLP


class PolicyGaussian(nn.Module):
    """MLP trunk -> mean head + state-independent action_log_std."""

    def __init__(self, input_dim: int, action_dim: int,
                 hidden_dims: Sequence[int] = (300, 200),
                 activation: str = "relu", log_std_init: float = 0.0):
        super().__init__()
        self.net = MLP(input_dim, hidden_dims, activation)
        self.action_mean = nn.Linear(self.net.out_dim, action_dim)
        self.action_log_std = nn.Parameter(
            torch.full((action_dim,), float(log_std_init)))

    def forward(self, x: torch.Tensor):
        mean = self.action_mean(self.net(x))
        return mean, self.action_log_std.expand_as(mean)


class Value(nn.Module):
    """MLP trunk -> scalar value head."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (300, 200),
                 activation: str = "relu"):
        super().__init__()
        self.net = MLP(input_dim, hidden_dims, activation)
        self.value_head = nn.Linear(self.net.out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.value_head(self.net(x))[..., 0]
