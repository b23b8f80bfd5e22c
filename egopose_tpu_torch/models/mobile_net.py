"""MobileNet-v1 trunk + ``fc`` head (counterpart of
egopose_tpu/models/mobile_net.py): conv_bn, 13 depthwise-separable
blocks, global average pool.  Submodules keep the JAX package's names
(``c0_conv``, ``c0_bn``, ``dw{i}_dw``, ``dw{i}_dwbn``, ``dw{i}_pw``,
``dw{i}_pwbn``, ``fc``)."""
from __future__ import annotations

import torch
from torch import nn

from .batch_norm import BatchNorm

PLAN = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1),
        (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1))


class MobileNet(nn.Module):
    def __init__(self, out_dim: int = 128, in_channels: int = 3):
        super().__init__()
        self.c0_conv = nn.Conv2d(in_channels, 32, 3, 2, 1, bias=False)
        self.c0_bn = BatchNorm(32)
        inp = 32
        for i, (oup, stride) in enumerate(PLAN):
            self.add_module(f"dw{i}_dw", nn.Conv2d(
                inp, inp, 3, stride, 1, groups=inp, bias=False))
            self.add_module(f"dw{i}_dwbn", BatchNorm(inp))
            self.add_module(f"dw{i}_pw", nn.Conv2d(inp, oup, 1, bias=False))
            self.add_module(f"dw{i}_pwbn", BatchNorm(oup))
            inp = oup
        self.fc = nn.Linear(1024, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) frames -> (N, out_dim)."""
        x = torch.relu(self.c0_bn(self.c0_conv(x)))
        for i in range(len(PLAN)):
            layer = lambda name: getattr(self, f"dw{i}_{name}")
            x = torch.relu(layer("dwbn")(layer("dw")(x)))
            x = torch.relu(layer("pwbn")(layer("pw")(x)))
        return self.fc(x.mean((-2, -1)))
