"""Policy and value networks (counterpart of egopose_tpu/rl/nets.py)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..models.mlp import MLP


def _scaled_head(in_dim: int, out_dim: int) -> nn.Linear:
    """Output head initialized as the reference's: torch's default weights
    scaled by 0.1, zero bias."""
    head = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        head.weight.mul_(0.1)
        head.bias.zero_()
    return head


class PolicyGaussian(nn.Module):
    """MLP trunk -> mean head + state-independent action_log_std; with
    ``fix_std`` the log-std gets no gradient (it is set by the schedule)."""

    def __init__(self, input_dim: int, action_dim: int,
                 hidden_dims: Sequence[int] = (300, 200),
                 activation: str = "relu", log_std_init: float = 0.0,
                 fix_std: bool = False):
        super().__init__()
        self.fix_std = fix_std
        self.net = MLP(input_dim, hidden_dims, activation)
        self.action_mean = _scaled_head(self.net.out_dim, action_dim)
        self.action_log_std = nn.Parameter(
            torch.full((action_dim,), float(log_std_init)))

    def forward(self, x: torch.Tensor):
        mean = self.action_mean(self.net(x))
        log_std = self.action_log_std.detach() if self.fix_std \
            else self.action_log_std
        return mean, log_std.expand_as(mean)


class PolicyDiscrete(nn.Module):
    """MLP trunk -> logits over ``action_num`` actions (a softmax policy);
    the head initialized as PolicyGaussian's mean head."""

    def __init__(self, input_dim: int, action_num: int,
                 hidden_dims: Sequence[int] = (300, 200),
                 activation: str = "relu"):
        super().__init__()
        self.net = MLP(input_dim, hidden_dims, activation)
        self.action_head = _scaled_head(self.net.out_dim, action_num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.action_head(self.net(x))


class Value(nn.Module):
    """MLP trunk -> scalar value head."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (300, 200),
                 activation: str = "relu"):
        super().__init__()
        self.net = MLP(input_dim, hidden_dims, activation)
        self.value_head = _scaled_head(self.net.out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.value_head(self.net(x))[..., 0]
