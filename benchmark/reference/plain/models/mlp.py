"""MLP (counterpart of egopose_tpu/models/mlp.py): Linear layers with an
activation after every hidden layer."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid}


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (128, 128),
                 activation: str = "tanh"):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        dims = [input_dim, *hidden_dims]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.out_dim = dims[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = self.act(layer(x))
        return x
