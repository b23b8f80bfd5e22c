"""ResNet-18 trunk + ``fc`` head (counterpart of
egopose_tpu/models/resnet.py): NCHW convolutions, flax-semantics
BatchNorm, global average pool.  Submodules keep the JAX package's names
(``conv1``, ``bn1``, ``layer1_0`` ... ``layer4_1`` with ``down_conv`` /
``down_bn``, ``fc``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .batch_norm import BatchNorm

PLAN = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))


class BasicBlock(nn.Module):
    def __init__(self, n_in: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(n_in, filters, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(filters)
        if n_in != filters or stride != 1:
            self.down_conv = nn.Conv2d(n_in, filters, 1, stride, bias=False)
            self.down_bn = BatchNorm(filters)
        else:
            self.down_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.down_conv is None \
            else self.down_bn(self.down_conv(x))
        return torch.relu(y + res)


class ResNet18(nn.Module):
    def __init__(self, out_dim: int = 128, in_channels: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.blocks = []
        n_in = 64
        for i, (filters, blocks, stride) in enumerate(PLAN):
            for b in range(blocks):
                name = f"layer{i + 1}_{b}"
                self.add_module(name, BasicBlock(
                    n_in, filters, stride if b == 0 else 1))
                self.blocks.append(name)
                n_in = filters
        self.fc = nn.Linear(512, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) frames -> (N, out_dim)."""
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.fc(x.mean((-2, -1)))
